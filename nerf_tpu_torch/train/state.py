"""Train state: step, model, optimizer and seed (counterpart of
``nerf_tpu/train/state.py``).

The model's parameters live in the ``nn.Module`` and Adam's moments in the
``torch.optim.Adam``, which the steps update in place.  Adam takes optax's
defaults (betas 0.9/0.999, eps 1e-8); optax's ``m_hat / (sqrt(v_hat) +
eps)`` is torch's formula.

``fold_key`` becomes ``step_generator``: a ``torch.Generator`` seeded from
``(seed, step)`` alone, so K chained steps equal K single steps and a
resumed run continues the same trajectory.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    seed: int = 0


def make_adam(model: nn.Module, learning_rate: float) -> torch.optim.Adam:
    """``optax.adam(learning_rate)`` for the model's parameters."""
    return torch.optim.Adam(
        model.parameters(), lr=learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS
    )


def create_train_state(
    model: nn.Module, learning_rate: float = 1e-4, seed: int = 0,
    optimizer: torch.optim.Optimizer = None,
) -> TrainState:
    return TrainState(
        step=0, model=model,
        optimizer=optimizer if optimizer is not None else make_adam(model, learning_rate),
        seed=seed,
    )


def step_generator(state: TrainState, device) -> torch.Generator:
    """This step's generator on ``device``, a function of (seed, step)
    only (stable across resume)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(state.seed) * 1_000_003 + int(state.step)) % (2**63))
    return gen
