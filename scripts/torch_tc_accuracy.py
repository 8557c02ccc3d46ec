"""How accurate the tensor-core products of K2, K3, K4 and K9 are, on the card.

    python scripts/torch_tc_accuracy.py

Runs the products of ``csrc/tc_mlp.cuh`` alone (``csrc/tc_product.cu``):
the row-tile product (``tc_linear``: out = a @ w, as K4's tile and K2's,
K3's and K9's forward and ``bwd_rows`` run it) at 4096 rows, K = 256, H =
256, and the weight-gradient product (``tc_wgrad``: out = a^T b over the
points, as their ``wgrad`` runs it) at 256 x 256 over 1000 and 15,744
points (one split of K9's step at 2048 x (64 + 128)), on uniform inputs in
[-1, 1) from a seed.
For each it prints, relative to the largest entry of the float64 product,
the largest error, the root-mean-square error and the mean error in the
direction of each entry (a bias toward zero is negative) of the kernel,
of the CPU emulation of the same arithmetic (``tc_mlp.tc_matmul``) and of
PyTorch's float32 product (TF32 off).  Then the same for the bf16 products
of compute_dtype="bfloat16" (``tc_linear_bf16``, ``tc_wgrad_bf16``): against
the float64 product of the bf16-rounded operands (the error of the tensor
cores' sums alone), with the emulation ``tc_mlp.bf16_matmul`` beside them,
and the bf16 product's distance from the float64 product of the unrounded
operands.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the card line)
from nerf_tpu_torch.ops.kernels import _build, tc_mlp  # noqa: E402


def report(name: str, got: dict, exact: torch.Tensor) -> None:
    scale = float(exact.abs().max())
    for label, value in got.items():
        err = value.double() - exact
        print(f"{name} {label:8s} max {float(err.abs().max()) / scale:.2e}  "
              f"rms {float(err.pow(2).mean().sqrt()) / scale:.2e}  "
              f"bias {float((err * exact.sign()).mean()) / scale:+.2e}")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tc_accuracy: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(chip_smoke.nvidia_smi("name,power.limit"))
    lib = _build.load("tc_product")
    stream = torch.cuda.current_stream(device).cuda_stream
    gen = torch.Generator(device=device).manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device) * 2 - 1

    rows, k, h = 4096, 256, 256
    a, w = rand(rows, k), rand(k, h)
    out = torch.empty((rows, h), device=device)
    _build.check_launch("tc_linear", lib.tc_linear(
        a.data_ptr(), tc_mlp.operand_image(w.t()).data_ptr(), out.data_ptr(), rows, k, h,
        stream))
    torch.cuda.synchronize()
    report(f"tc_linear {rows}x{k}x{h}", {"kernel": out, "emulated": tc_mlp.tc_matmul(a, w),
                                         "float32": a @ w}, a.double() @ w.double())

    for points in (1000, 15744):
        a, b = rand(points, h), rand(points, h)
        out = torch.empty((h, h), device=device)
        _build.check_launch("tc_wgrad", lib.tc_wgrad(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), points, h, h, stream))
        torch.cuda.synchronize()
        report(f"tc_wgrad {points} points", {"kernel": out,
                                             "emulated": tc_mlp.tc_matmul(a.t(), b),
                                             "float32": a.t() @ b},
               a.double().t() @ b.double())

    r = tc_mlp.bf16_round
    a, w = rand(rows, k), rand(k, h)
    out = torch.empty((rows, h), device=device)
    _build.check_launch("tc_linear_bf16", lib.tc_linear_bf16(
        a.data_ptr(), tc_mlp.operand_image(w.t(), torch.bfloat16).data_ptr(), out.data_ptr(),
        rows, k, h, stream))
    torch.cuda.synchronize()
    report(f"tc_linear_bf16 {rows}x{k}x{h} vs rounded operands",
           {"kernel": out, "emulated": tc_mlp.bf16_matmul(a, w)}, r(a).double() @ r(w).double())
    report(f"tc_linear_bf16 {rows}x{k}x{h} vs unrounded", {"kernel": out},
           a.double() @ w.double())
    for points in (1000, 15744):
        a, b = rand(points, h), rand(points, h)
        out = torch.empty((h, h), device=device)
        _build.check_launch("tc_wgrad_bf16", lib.tc_wgrad_bf16(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), points, h, h, stream))
        torch.cuda.synchronize()
        report(f"tc_wgrad_bf16 {points} points vs rounded operands",
               {"kernel": out, "emulated": tc_mlp.bf16_matmul(a.t(), b)},
               r(a).double().t() @ r(b).double())
    return 0


if __name__ == "__main__":
    sys.exit(main())
