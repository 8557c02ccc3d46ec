"""Configuration dataclasses for the PyTorch/CUDA port of the NeRF framework.

A field-for-field copy of ``nerf_tpu/config.py`` with the same defaults, so
``config_to_json`` writes identical text for both packages.

One config system covering the union of both reference API generations
(SURVEY.md §0): the v1.2 "classic NeRF" (8-layer skip MLP, view branch,
near/far stratified + hierarchical sampling — reconstructed in SURVEY.md
§2.3) and the HEAD mip-NeRF generation (IPE cone casting, LayerNorm MLP,
segmentation head — the reference's ``nerf/model.py:471-542``).  Replaces
the reference's argparse flags (``train_conditional_nerf.py:20-49``) and
constructor kwargs (``model.py:471-475``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ClassicNeRFConfig:
    """The v1.2-generation architecture, pinned by ``examples/nerf.pth``.

    Checkpoint evidence (SURVEY.md §2.3): trunk of 8 Linears in two blocks of
    4 (input 60 = density_inputs * x_positional_encoding_size; skip concat
    316 = 256 + 60), each Linear -> ReLU -> LayerNorm; density head off the
    trunk; view-conditioned color branch of 2 Linears (input 292 = 256 + 36).
    """

    hidden_size: int = 256
    # Per-scalar encoding width (sin+cos count => L = size // 2 frequencies).
    x_positional_encoding_size: int = 20  # L = 10, classic NeRF
    d_positional_encoding_size: int = 12  # L = 6
    # Raw input scalars; latent-conditioned ("conditional NeRF") models widen
    # these: density_inputs = 3 + states_x dim, color_inputs = 3 + states_d
    # dim (reference train_conditional_nerf.py:103-104, docstrings at
    # model.py:392-397).
    density_inputs: int = 3
    color_inputs: int = 3
    color_outputs: int = 3
    trunk_blocks: Tuple[int, ...] = (4, 4)  # Linears per trunk block
    view_branch_depth: int = 2
    use_viewdirs: bool = True
    # Scene scale: the classic encoder's lowest frequency is
    # pi / (2 * normalize_position) (reference model.py:216-224;
    # NeRF(normalize_position=6.0) in the notebook).
    normalize_position: float = 20.0
    # Encode view directions with the same bbox-derived base frequency the
    # positions use (the surviving reference encoder is a model method using
    # the model bbox for everything).
    normalize_direction: Optional[float] = None  # None => normalize_position
    # Take the fused path through the hand-written CUDA kernels
    # (ops/kernels/classic_mlp.py for every MLP evaluation, and
    # ops/kernels/union_eval.py for the deterministic hierarchical-reuse
    # fine stage).  The name is kept from the JAX package.  Given CPU
    # tensors the kernel wrappers run their plain PyTorch versions.
    use_pallas: bool = False
    # Matmul input dtype for the point MLP ("float32" or "bfloat16").  The
    # port's kernels take float32 only and raise NotImplementedError for
    # "bfloat16".
    compute_dtype: str = "float32"

    @property
    def x_encoding_dim(self) -> int:
        return self.density_inputs * self.x_positional_encoding_size

    @property
    def d_encoding_dim(self) -> int:
        return self.color_inputs * self.d_positional_encoding_size

    @property
    def direction_bound(self) -> float:
        return (
            self.normalize_position
            if self.normalize_direction is None
            else self.normalize_direction
        )


@dataclasses.dataclass(frozen=True)
class MipNeRFConfig:
    """The HEAD-generation architecture (reference ``model.py:471-542``).

    IPE cone-cast features (96-dim for encoding_size=32), 5 hidden Linears
    each Linear -> LayerNorm -> ReLU, an output Linear to
    ``1 + color + segmentation`` logits; log-spaced bbox sampling.
    """

    hidden_size: int = 256
    encoding_size: int = 32  # feature dim = 3 * encoding_size
    num_hidden_layers: int = 5
    color_outputs: int = 3
    segmentation_outputs: int = 50
    focal_length: float = 112.0
    bbox_min: Tuple[float, float, float] = (-20.0, -20.0, -20.0)
    bbox_max: Tuple[float, float, float] = (20.0, 20.0, 20.0)
    ray_shape: str = "cone"
    # Fused point-MLP kernel (not ported yet: the mip family runs plain).
    use_pallas: bool = False
    # Matmul input dtype ("float32" or "bfloat16"); see ClassicNeRFConfig.
    compute_dtype: str = "float32"

    @property
    def min_deg(self) -> int:
        return -4  # reference model.py:550-551

    @property
    def max_deg(self) -> int:
        return self.encoding_size // 2 - 4

    @property
    def feature_dim(self) -> int:
        return 3 * self.encoding_size

    @property
    def num_outputs(self) -> int:
        return 1 + self.color_outputs + self.segmentation_outputs

    @property
    def bbox_diagonal(self) -> float:
        import math

        return math.sqrt(
            sum((hi - lo) ** 2 for lo, hi in zip(self.bbox_min, self.bbox_max))
        )


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Sampling + compositing knobs for one render/train pass."""

    num_coarse_samples: int = 64
    num_fine_samples: int = 0  # 0 => no hierarchical stage
    near: float = 2.0
    far: float = 6.0
    randomly_sample: bool = True
    density_noise_std: float = 0.0
    # Rays per tile for full-image rendering (``render_image`` loops over
    # tiles of this many rays).  The default is the JAX package's, which
    # chose it by a sweep on its own hardware; it has not been swept for
    # the port.
    rays_per_tile: int = 4000
    white_background: bool = False
    use_ndc: bool = False
    # Hierarchical fine stage: reuse the coarse MLP outputs and evaluate the
    # network only on the NEW fine samples, compositing the disjoint union
    # with order-free masked reductions (ops/compositing.py::
    # weights_from_unsorted) — 25% fewer MLP point-evals per step at
    # identical deterministic renders (up to float reassociation).  False
    # restores the NeRF-paper re-evaluate-everything formulation (also what
    # the sample-parallel path implements).
    reuse_coarse_in_fine: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop knobs (reference argparse flags + notebook cell 7-8)."""

    batch_size: int = 1024
    learning_rate: float = 1e-4
    num_steps: int = 40_000
    density_noise_std: float = 1.0
    log_interval: int = 1000
    eval_interval: int = 1000
    checkpoint_interval: int = 1000
    seed: int = 0
    # Loss summed over coarse+fine stages, eval on finest (reference
    # train_conditional_nerf.py:132 semantics).
    coarse_loss_weight: float = 1.0
    # Mixed precision: bfloat16 activations/matmuls with float32 params.
    compute_dtype: str = "float32"
    # Fused Pallas kernel for the point MLP where available.
    use_pallas: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for multi-chip / multi-host runs.

    Rays are pure-data-parallel over the ``batch`` axis (SURVEY.md §2.2:
    params are ~0.3-0.6M so replication + psum over ICI is the right
    decomposition); the sample axis always stays on-chip.
    """

    data_axis: str = "batch"
    num_devices: int = 0  # 0 => all visible devices


def config_to_json(cfg) -> str:
    """Serialize any config dataclass (provenance dump, replacing the
    reference's params.json at ``train_conditional_nerf.py:53-69``)."""
    return json.dumps(dataclasses.asdict(cfg), indent=2, sort_keys=True)
