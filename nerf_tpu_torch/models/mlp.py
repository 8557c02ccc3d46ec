"""The NeRF MLPs as PyTorch modules: the classic (v1.2-generation) MLP and
the HEAD-generation (mip) MLP.

Counterpart of ``nerf_tpu/models/mlp.py`` (``init_classic_mlp``,
``apply_classic_mlp``, ``init_mip_mlp``, ``apply_mip_mlp``,
``init_residual_block``, ``apply_residual_block``, ``count_params``).  The
classic MLP:

* ``block_0``: 4 x (Linear -> ReLU -> LayerNorm) on the x encoding;
* ``block_1``: 4 more, the first on the skip concat ``[h, x_enc]``;
* ``density``: Linear head off the trunk;
* ``block_2``: the view branch, 2 layers, the first on ``[h, d_enc]``
  (absent when ``use_viewdirs=False``, where the color head reads the
  trunk);
* ``color``: Linear head.

The ``nn.Sequential`` layout makes the ``state_dict`` keys those of the
reference ``.pth`` checkpoint (``block_0.{0,3,6,9}`` Linears,
``block_0.{2,5,8,11}`` LayerNorms, ...).  Weights keep torch's
``(out, in)`` layout; ``utils/pth_import.py`` transposes to and from the JAX
package's ``(in, out)``.

The mip MLP (``MipMLP``) is ``num_hidden_layers`` x (Linear -> LayerNorm ->
ReLU), LayerNorm BEFORE ReLU (the reverse of the classic order), then one
Linear to ``1 + color + segmentation`` logits, in one ``nn.Sequential``
named ``prediction_heads`` as the reference HEAD model has it (Linear at
3i, LayerNorm at 3i+1, ReLU at 3i+2, the output Linear last).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from nerf_tpu_torch.config import ClassicNeRFConfig, MipNeRFConfig

LAYER_NORM_EPS = 1e-5


@torch.no_grad()
def _reset_parameters(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """torch's ``nn.Linear`` default distribution, U(+-1/sqrt(in)) for
    weights and biases, drawn from ``generator`` (a CPU generator, so a
    seed gives the same weights on every device); LayerNorms at identity."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            for p in (m.weight, m.bias):
                values = torch.empty(p.shape).uniform_(-bound, bound, generator=generator)
                p.copy_(values)
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()


def _block(first_in: int, hidden: int, depth: int) -> nn.Sequential:
    layers = []
    for i in range(depth):
        layers += [
            nn.Linear(first_in if i == 0 else hidden, hidden),
            nn.ReLU(),
            nn.LayerNorm(hidden, eps=LAYER_NORM_EPS),
        ]
    return nn.Sequential(*layers)


class ClassicMLP(nn.Module):
    """The v1.2 MLP: ``forward(x_enc, d_enc) -> (density, color_logits)``,
    both raw (the renderer applies relu and sigmoid while compositing)."""

    def __init__(
        self,
        cfg: ClassicNeRFConfig,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        n0, n1 = cfg.trunk_blocks
        self.block_0 = _block(cfg.x_encoding_dim, h, n0)
        self.block_1 = _block(h + cfg.x_encoding_dim, h, n1)
        self.density = nn.Linear(h, 1)
        if cfg.use_viewdirs:
            self.block_2 = _block(h + cfg.d_encoding_dim, h, cfg.view_branch_depth)
        self.color = nn.Linear(h, cfg.color_outputs)
        self.reset_parameters(generator)
        self.to(device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Weights drawn anew from ``generator`` (``_reset_parameters``)."""
        _reset_parameters(self, generator)

    def forward(
        self, x_enc: torch.Tensor, d_enc: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.block_0(x_enc)
        h = self.block_1(torch.cat([h, x_enc], dim=-1))
        density = self.density(h)
        if self.cfg.use_viewdirs:
            if d_enc is None:
                raise ValueError("use_viewdirs=True requires encoded directions")
            h = self.block_2(torch.cat([h, d_enc], dim=-1))
        return density, self.color(h)


class MipMLP(nn.Module):
    """The HEAD MLP: ``forward(features) -> (density, color_logits,
    segmentation_logits)``, all raw, split off one output Linear."""

    def __init__(
        self,
        cfg: MipNeRFConfig,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        layers = []
        for i in range(cfg.num_hidden_layers):
            layers += [
                nn.Linear(cfg.feature_dim if i == 0 else h, h),
                nn.LayerNorm(h, eps=LAYER_NORM_EPS),
                nn.ReLU(),
            ]
        self.prediction_heads = nn.Sequential(*layers, nn.Linear(h, cfg.num_outputs))
        self.reset_parameters(generator)
        self.to(device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Weights drawn anew from ``generator`` (``_reset_parameters``)."""
        _reset_parameters(self, generator)

    def forward(self, features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        out = self.prediction_heads(features)
        c = self.cfg.color_outputs
        return out[..., :1], out[..., 1:1 + c], out[..., 1 + c:]


class ResidualBlock(nn.Module):
    """The reference's residual block (dead code there, kept for parity):
    ``LayerNorm(x + Linear(GELU(Linear(x))))``, GELU in its exact erf
    form, with the reference's ``state_dict`` keys (``linear_one``,
    ``linear_two``, ``layer_norm``)."""

    def __init__(self, hidden_size: int, feedforward_size: int,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.linear_one = nn.Linear(hidden_size, feedforward_size)
        self.linear_two = nn.Linear(feedforward_size, hidden_size)
        self.layer_norm = nn.LayerNorm(hidden_size, eps=LAYER_NORM_EPS)
        _reset_parameters(self, generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.linear_two(torch.nn.functional.gelu(self.linear_one(x)))
        return self.layer_norm(x + h)


def init_residual_block(hidden_size: int, feedforward_size: int,
                        generator: Optional[torch.Generator] = None,
                        device="cuda") -> ResidualBlock:
    """A ``ResidualBlock`` with torch's ``nn.Linear`` initialisation drawn
    from ``generator`` and the LayerNorm at identity."""
    return ResidualBlock(hidden_size, feedforward_size, generator, device)


def apply_residual_block(block: ResidualBlock, x: torch.Tensor) -> torch.Tensor:
    return block(x)


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
