"""Which rows move K1-bwd's gradients near a ReLU kink, on the card.

    python scripts/torch_kink_rows.py

Draws the full-width case of
``tests/test_torch_cuda.py::test_classic_mlp_bwd_kernel_matches_plain`` on
plain random rows (hidden 256, 200 points, seed 3; the test itself now
draws its rows away from the kinks) and holds K1-bwd without the
encodings' cotangents (3xTF32 on the tensor cores) against its float32
plain version.  Prints the rows whose smallest |ReLU input| under the plain
forward lies below 1e-5, with that margin, then the largest gradient
difference over the largest entry of the full call's gradient (the test's
bound is 1e-4) with every row's cotangent, with only each listed row's,
and with the listed rows' cotangents set to zero.  Exits non-zero without
a GPU.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import chip_smoke  # noqa: E402  (the card line)
import test_torch_cuda as card  # noqa: E402  (the test's inputs and kink margins)
from nerf_tpu_torch.ops.kernels import classic_mlp  # noqa: E402

POINTS, MARGIN = 200, 1e-5


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kink_rows: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(chip_smoke.nvidia_smi("name,power.limit"))
    cfg, packed = card.packed_weights("full_width", device)
    gen = torch.Generator(device=device).manual_seed(3)
    x = card.rand(gen, POINTS, cfg.x_encoding_dim)
    d = card.rand(gen, POINTS, cfg.d_encoding_dim)
    g_out = card.rand(gen, POINTS, 1 + cfg.color_outputs)
    with torch.no_grad():
        margin = card.kink_margin(packed, x, d)
    near = torch.nonzero(margin < MARGIN)[:, 0].tolist()
    print(f"rows within {MARGIN} of a kink: "
          + ", ".join(f"{r} ({float(margin[r]):.2e})" for r in near))
    _, _, scale_ref = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out, input_grads=False)
    scale = {k: float(v.abs().max()) + 1e-12 for k, v in scale_ref.items()}

    def worst(g):
        _, _, got = classic_mlp.classic_mlp_bwd(packed, x, d, g, input_grads=False)
        _, _, ref = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g, input_grads=False)
        errs = {k: float((got[k] - ref[k]).abs().max()) / scale[k] for k in ref}
        key = max(errs, key=errs.get)
        return f"{errs[key]:.3e} ({key})"

    print(f"every row: largest difference {worst(g_out)} of the largest entry (bound 1e-4)")
    for r in near:
        only = torch.zeros_like(g_out)
        only[r] = g_out[r]
        print(f"row {r} alone: {worst(only)}")
    rest = g_out.clone()
    rest[near] = 0.0
    print(f"without those rows: {worst(rest)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
