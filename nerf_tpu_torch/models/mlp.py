"""The classic (v1.2-generation) NeRF MLP as a PyTorch module.

Counterpart of the classic half of ``nerf_tpu/models/mlp.py``
(``init_classic_mlp``, ``apply_classic_mlp``, ``count_params``):

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
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from nerf_tpu_torch.config import ClassicNeRFConfig

LAYER_NORM_EPS = 1e-5


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

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """torch's ``nn.Linear`` default distribution, U(+-1/sqrt(in)) for
        weights and biases, drawn from ``generator`` (a CPU generator, so a
        seed gives the same weights on every device); LayerNorms at
        identity."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                for p in (m.weight, m.bias):
                    values = torch.empty(p.shape).uniform_(-bound, bound, generator=generator)
                    p.copy_(values)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()

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


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
