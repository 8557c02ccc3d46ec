"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use, with ``nvcc`` only (plain C
interface, no PyTorch headers), into ``build/nerf_tpu_torch/lib<name>.so``
beside the package, and loaded with ``ctypes``.  A library is rebuilt when a
source under ``csrc/`` is newer than it.  Nothing here runs at import time,
so machines without ``nvcc`` import the package freely.

``launch_counts`` counts kernel launches by kernel name: each wrapper adds
one where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "nerf_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = ("classic_mlp_fwd", "union_eval", "classic_mlp_bwd", "train_grads", "fine_stage_train")

launch_counts: collections.Counter = collections.Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_WEIGHT_ARGS = (_P,) * 11  # w0 wx wd whh b g beta w_dens b_dens w_col b_col
ARGTYPES = {
    # x d out P xe de hidden c, weights, stream
    "classic_mlp_fwd": (_P, _P, _P, _I, _I, _I, _I, _I) + _WEIGHT_ARGS + (_P,),
    # xf d t_c t_f dens_c col_c dnorm out R Sc Sf xe de hidden c, weights, stream
    "union_eval": (_P,) * 8 + (_I,) * 7 + _WEIGHT_ARGS + (_P,),
    # x d gout dx dd grads P xe de hidden c, weights,
    # xhat stats dpre wpart tpart tmp wt out splits stream
    "classic_mlp_bwd": (_P,) * 6 + (_I,) * 5 + _WEIGHT_ARGS + (_P,) * 8 + (_I, _P),
    # x d dists noise pix loss grads weights_out R S xe de hidden c white
    # loss_weight, weights, xhat stats dpre wpart tpart tmp wt out gout
    # ray_loss splits stream
    "train_grads": (_P,) * 8 + (_I,) * 7 + (_F,) + _WEIGHT_ARGS + (_P,) * 10 + (_I, _P),
    # xf d t_c t_f dens_c col_c dnorm noise_f pix loss grads g_dens_c g_col_c
    # R Sc Sf xe de hidden c white loss_weight, weights, xhat stats dpre
    # wpart tpart tmp wt out gout ray_loss splits stream
    "fine_stage_train": (_P,) * 13 + (_I,) * 8 + (_F,) + _WEIGHT_ARGS + (_P,) * 10 + (_I, _P),
}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    return lib.stat().st_mtime < newest


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile the stale kernels, one ``nvcc`` per source, all started
    together.  Returns the compiler's ``-Xptxas -v`` report per kernel
    (empty for a kernel that was up to date); raises if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    reports = {name: "" for name in names}
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _LIBS:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(lib, name)
        fn.argtypes = ARGTYPES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError_t {err}")
