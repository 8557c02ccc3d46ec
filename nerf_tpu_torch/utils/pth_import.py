"""Weight carry-across between the JAX package's parameter pytree, reference
``.pth`` checkpoints, ``ClassicMLP`` and ``MipMLP``.

``ClassicMLP``'s ``state_dict`` keys are the reference checkpoint's
(``block_0.{0,3,6,9}`` Linear, ``block_0.{2,5,8,11}`` LayerNorm, ``block_1``
likewise, ``block_2.{0,3}`` / ``block_2.{2,5}``, ``density``, ``color``), so a
``.pth`` loads directly.  The JAX package stores Linear weights ``(in, out)``
under ``{"linear": {"w", "b"}, "ln": {"scale", "bias"}}`` per layer; the
conversions here transpose ``w`` (counterpart of
``nerf_tpu/utils/pth_import.py``).  Pytrees are nested dicts and lists of
numpy arrays, so this module needs no JAX.

``MipMLP``'s ``state_dict`` keys are the reference HEAD model's
(``prediction_heads.{3i}`` Linear, ``prediction_heads.{3i+1}`` LayerNorm,
the output Linear last); the JAX mip pytree is ``{"layers": [{"linear",
"ln"}, ...], "out": {"w", "b"}}``.  The JAX package has no mip ``.pth``
format, and this module adds none.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from nerf_tpu_torch.config import ClassicNeRFConfig, MipNeRFConfig
from nerf_tpu_torch.models.mlp import ClassicMLP

_BLOCKS = ("block_0", "block_1", "block_2")


def classic_state_dict_from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ClassicNeRF pytree (numpy leaves) -> ``ClassicMLP`` state_dict."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key: str, value) -> None:
        sd[key] = torch.tensor(np.asarray(value), dtype=torch.float32)

    for name in ("density", "color"):
        put(f"{name}.weight", np.asarray(params[name]["w"]).T)
        put(f"{name}.bias", params[name]["b"])
    for name in _BLOCKS:
        for i, layer in enumerate(params.get(name, ())):
            # Sequential indices: Linear at 3i, ReLU at 3i+1, LayerNorm at 3i+2.
            put(f"{name}.{3 * i}.weight", np.asarray(layer["linear"]["w"]).T)
            put(f"{name}.{3 * i}.bias", layer["linear"]["b"])
            put(f"{name}.{3 * i + 2}.weight", layer["ln"]["scale"])
            put(f"{name}.{3 * i + 2}.bias", layer["ln"]["bias"])
    return sd


def jax_params_from_classic_state_dict(
    state_dict: Mapping[str, torch.Tensor], cfg: ClassicNeRFConfig
) -> Dict[str, Any]:
    """``ClassicMLP`` (or reference ``.pth``) state_dict -> JAX ClassicNeRF
    pytree with numpy leaves."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}

    def linear(prefix: str) -> Dict[str, np.ndarray]:
        return {"w": np.ascontiguousarray(sd[f"{prefix}.weight"].T), "b": sd[f"{prefix}.bias"]}

    def block(name: str, depth: int) -> list:
        return [
            {
                "linear": linear(f"{name}.{3 * i}"),
                "ln": {"scale": sd[f"{name}.{3 * i + 2}.weight"],
                       "bias": sd[f"{name}.{3 * i + 2}.bias"]},
            }
            for i in range(depth)
        ]

    n0, n1 = cfg.trunk_blocks
    params: Dict[str, Any] = {
        "block_0": block("block_0", n0),
        "block_1": block("block_1", n1),
        "density": linear("density"),
        "color": linear("color"),
    }
    if cfg.use_viewdirs:
        params["block_2"] = block("block_2", cfg.view_branch_depth)
    return params


def mip_state_dict_from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX MipNeRF pytree (numpy leaves) -> ``MipMLP`` state_dict."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key: str, value) -> None:
        sd[key] = torch.tensor(np.asarray(value), dtype=torch.float32)

    layers = params["layers"]
    for i, layer in enumerate(layers):
        put(f"prediction_heads.{3 * i}.weight", np.asarray(layer["linear"]["w"]).T)
        put(f"prediction_heads.{3 * i}.bias", layer["linear"]["b"])
        put(f"prediction_heads.{3 * i + 1}.weight", layer["ln"]["scale"])
        put(f"prediction_heads.{3 * i + 1}.bias", layer["ln"]["bias"])
    put(f"prediction_heads.{3 * len(layers)}.weight", np.asarray(params["out"]["w"]).T)
    put(f"prediction_heads.{3 * len(layers)}.bias", params["out"]["b"])
    return sd


def jax_params_from_mip_state_dict(
    state_dict: Mapping[str, torch.Tensor], cfg: MipNeRFConfig
) -> Dict[str, Any]:
    """``MipMLP`` state_dict -> JAX MipNeRF pytree with numpy leaves."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}

    def linear(i: int) -> Dict[str, np.ndarray]:
        return {"w": np.ascontiguousarray(sd[f"prediction_heads.{i}.weight"].T),
                "b": sd[f"prediction_heads.{i}.bias"]}

    n = cfg.num_hidden_layers
    return {
        "layers": [
            {"linear": linear(3 * i),
             "ln": {"scale": sd[f"prediction_heads.{3 * i + 1}.weight"],
                    "bias": sd[f"prediction_heads.{3 * i + 1}.bias"]}}
            for i in range(n)
        ],
        "out": linear(3 * n),
    }


def load_classic_checkpoint(path: str, cfg: ClassicNeRFConfig, device="cuda") -> ClassicMLP:
    """Load a reference-layout ``.pth`` into a ``ClassicMLP`` on ``device``.
    Shape mismatches with ``cfg`` raise from ``load_state_dict``."""
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    mlp = ClassicMLP(cfg, device="cpu")
    mlp.load_state_dict(state_dict)
    return mlp.to(device)
