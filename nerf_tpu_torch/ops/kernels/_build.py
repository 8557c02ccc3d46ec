"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use, with ``nvcc`` only (plain C
interface, no PyTorch headers), into ``build/nerf_tpu_torch/lib<name>.so``
beside the package, and loaded with ``ctypes``.  A library is rebuilt when a
source under ``csrc/`` is newer than it.  Nothing here runs at import time,
so machines without ``nvcc`` import the package freely.

``launch_counts`` counts kernel launches by kernel name: each wrapper adds
one where it launches its kernel, and nowhere else.  ``policy_counts``
counts, by ``(kernel name, policy)``, which products a kernel's tile ran in
those calls: ``"tc"``, 3xTF32 on the tensor cores, or, for the bf16 kernels
of ``compute_dtype="bfloat16"`` (``<name>_bf16`` in the same library, for
every kernel: ``BF16``), ``"tc_bf16"``, the bf16 ``wgmma``.  Every kernel
has one tile (the classic and the mip tiles stream their encodings or
features through it at every width, ``csrc/tc_mlp.cuh`` note 9), so the
policy records the call's dtype.
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
KERNELS = (
    "classic_mlp_fwd", "union_eval", "classic_mlp_bwd", "train_grads", "fine_stage_train",
    "mip_mlp_fwd", "mip_mlp_bwd", "mip_eval", "mip_train_grads",
    "classic_pointmlp_fwd", "classic_pointmlp_bwd", "mega_train",
)

launch_counts: collections.Counter = collections.Counter()
policy_counts: collections.Counter = collections.Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_WEIGHT_ARGS = (_P,) * 11  # w0 wx wd whh b g beta w_dens b_dens w_col b_col
_MIP_WEIGHT_ARGS = (_P,) * 7  # w_in whh b g beta w_out b_out
ARGTYPES = {
    # x d out P xe de hidden c, weights, tc_fwd wide stream
    "classic_mlp_fwd": (_P, _P, _P, _I, _I, _I, _I, _I) + _WEIGHT_ARGS + (_P,) * 3,
    # xf d t_c t_f dens_c col_c dnorm out R Sc Sf xe de hidden c, weights,
    # tc_fwd fout scratch wide stream
    "union_eval": (_P,) * 8 + (_I,) * 7 + _WEIGHT_ARGS + (_P,) * 5,
    # R Sf: the blocks union_eval launches (its wide scratch's tiles)
    "union_eval_blocks": (_I,) * 2,
    # x d gout dx dd grads P xe de hidden c, weights,
    # xhat stats dpre wpart tpart tmp out splits stored tc_fwd tc_bwd stream
    "classic_mlp_bwd": (_P,) * 6 + (_I,) * 5 + _WEIGHT_ARGS + (_P,) * 7 + (_I,) * 2 + (_P,) * 3,
    # x d out P xe de hidden c, weights, xhat stats dpre tc_fwd stream (the
    # forward that keeps the chain for classic_mlp_bwd, in its library)
    "classic_mlp_fwd_store": (_P,) * 3 + (_I,) * 5 + _WEIGHT_ARGS + (_P,) * 5,
    # x d dists noise pix loss grads weights_out R S xe de hidden c white
    # loss_weight, weights, xhat stats dpre wpart tpart tmp out gout
    # ray_loss splits tc_fwd tc_bwd stream
    "train_grads": (_P,) * 8 + (_I,) * 7 + (_F,) + _WEIGHT_ARGS + (_P,) * 9 + (_I,)
    + (_P,) * 3,
    # xf d t_c t_f dens_c col_c dnorm noise_f pix loss grads g_dens_c g_col_c
    # R Sc Sf xe de hidden c white loss_weight, weights, xhat stats dpre
    # wpart tpart tmp out gout ray_loss ray_scratch splits tc_fwd tc_bwd stream
    "fine_stage_train": (_P,) * 13 + (_I,) * 8 + (_F,) + _WEIGHT_ARGS + (_P,) * 10 + (_I,)
    + (_P,) * 3,
    # x out P F hidden L O, weights, tc_fwd wide stream
    "mip_mlp_fwd": (_P,) * 2 + (_I,) * 5 + _MIP_WEIGHT_ARGS + (_P,) * 3,
    # x gout dx grads P F hidden L O, weights,
    # xhat stats dpre wpart tpart tmp out splits tc_fwd tc_bwd stream
    "mip_mlp_bwd": (_P,) * 4 + (_I,) * 5 + _MIP_WEIGHT_ARGS + (_P,) * 7 + (_I,) + (_P,) * 3,
    # x dists t_mids noise per_ray R n F hidden L C O white, weights,
    # mlp_out ray_scratch tc_fwd wide stream
    "mip_eval": (_P,) * 5 + (_I,) * 8 + _MIP_WEIGHT_ARGS + (_P,) * 5,
    # x dists noise pix labels loss grads R n F hidden L C O white
    # seg_weight, weights, xhat stats dpre wpart tpart tmp out gout
    # ray_loss ray_scratch splits tc_fwd tc_bwd stream
    "mip_train_grads": (_P,) * 7 + (_I,) * 8 + (_F,) + _MIP_WEIGHT_ARGS + (_P,) * 10 + (_I,)
    + (_P,) * 3,
    # pts dirs out P xe de hidden c sx phx sd phd, weights, tc_fwd wide stream
    "classic_pointmlp_fwd": (_P,) * 3 + (_I,) * 5 + (_P,) * 4 + _WEIGHT_ARGS + (_P,) * 3,
    # pts dirs gout dpts ddirs grads P xe de hidden c sx phx sd phd, weights,
    # xhat stats dpre wpart tpart tmp out x_enc d_enc dx_enc dd_enc splits
    # tc_fwd tc_bwd stream
    "classic_pointmlp_bwd": (_P,) * 6 + (_I,) * 5 + (_P,) * 4 + _WEIGHT_ARGS + (_P,) * 11
    + (_I,) + (_P,) * 3,
    # xc d_ray t_c noise_c u noise_f rays_o rays_d pix S is_cos loss grads
    # t_fine R Sc Sf xe de hidden c white exact_trig, weights, xhat stats dpre
    # wpart tpart tmp out gout x_all dnorm ray_loss ray_scratch splits
    # tc_fwd tc_bwd stream
    "mega_train": (_P,) * 14 + (_I,) * 9 + _WEIGHT_ARGS + (_P,) * 12 + (_I,) + (_P,) * 3,
    # The tensor-core products alone (csrc/tc_product.cu, for the card
    # tests): a img out P K hidden stream; a b out P M N splits div split
    # div2 stream.
    "tc_linear": (_P,) * 3 + (_I,) * 3 + (_P,),
    "tc_wgrad": (_P,) * 3 + (_I,) * 7 + (_P,),
}
# The kernels' bf16 entry points, <name>_bf16, whose arguments are
# <name>'s (the images bfloat16, and the encodings or the mip features,
# with K1-bwd's and K5-bwd's cotangents of them; K8's raw points stay
# float32 and its scratch encodings are bfloat16; K9's coarse, view and
# scratch encodings are bfloat16).
BF16 = KERNELS
ARGTYPES.update({f"{name}_bf16": ARGTYPES[name]
                 for name in BF16 + ("tc_linear", "tc_wgrad", "classic_mlp_fwd_store")})
# Functions of a library other than its own name.
FUNCTIONS = {
    "tc_product": ("tc_linear", "tc_wgrad", "tc_linear_bf16", "tc_wgrad_bf16"),
    **{name: (name,) + ((f"{name}_bf16",) if name in BF16 else ()) for name in KERNELS},
}
FUNCTIONS["union_eval"] += ("union_eval_blocks",)
FUNCTIONS["classic_mlp_bwd"] += ("classic_mlp_fwd_store", "classic_mlp_fwd_store_bf16")


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
        for fn_name in FUNCTIONS.get(name, (name,)):
            fn = getattr(lib, fn_name)
            fn.argtypes = ARGTYPES[fn_name]
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError_t {err}")
