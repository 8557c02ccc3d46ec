"""Metrics: PSNR with the reference's formula and structured run logging
(counterpart of ``nerf_tpu/train/metrics.py``).

``mse_to_psnr`` keeps the reference's ``-10 * ln(mse) / 2.30258509299``;
``MetricsLogger`` writes a JSONL stream and the reference-compatible
``psnrs.npy`` / ``iternums.npy`` dumps.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

LN10 = 2.30258509299  # the reference's hardcoded ln(10)


def mse_to_psnr(mse):
    """Reference formula: ``-10 * ln(mse) / LN10`` (tensor or float)."""
    if torch.is_tensor(mse):
        return -10.0 * torch.log(mse) / LN10
    return -10.0 * float(np.log(mse)) / LN10


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return mse_to_psnr(torch.mean((pred - target) ** 2))


class MetricsLogger:
    """Host-side scalar logger: JSONL stream + reference-style .npy dumps."""

    def __init__(self, logging_dir: Optional[str] = None):
        self.logging_dir = logging_dir
        self.history: List[Dict] = []
        self._t0 = time.time()
        self._jsonl = None
        if logging_dir:
            os.makedirs(logging_dir, exist_ok=True)
            self._jsonl = open(os.path.join(logging_dir, "metrics.jsonl"), "a")

    def log(self, step: int, **scalars) -> Dict:
        record = {"step": int(step), "wall_s": time.time() - self._t0}
        for k, v in scalars.items():
            if torch.is_tensor(v):
                v = v.detach().cpu().numpy()
            record[k] = float(v) if np.ndim(v) == 0 else np.asarray(v).tolist()
        self.history.append(record)
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        return record

    def series(self, name: str) -> List:
        return [r[name] for r in self.history if name in r]

    def save_npy_dumps(self) -> None:
        """Reference-compatible ``psnrs.npy`` and ``iternums.npy``."""
        if not self.logging_dir:
            return
        evals = [r for r in self.history if "psnr" in r]
        np.save(os.path.join(self.logging_dir, "psnrs.npy"),
                np.asarray([r["psnr"] for r in evals]))
        np.save(os.path.join(self.logging_dir, "iternums.npy"),
                np.asarray([r["step"] for r in evals]))

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
