"""The rules of the tensor-core tiles' bulk copies, on the CPU.

The row-tile product (``csrc/tc_mlp.cuh``'s ``tc_gemm``) has its B chunks
copied by a producer warp, one ``cp.async.bulk`` a chunk, straight from the
operand images ``tc_mlp.tc_images`` builds: each copy's global address and
size must be multiples of 16 bytes, and the copies of a call must walk the
image chunk after chunk.  ``tc_mlp.bulk_copies`` mirrors the kernels'
addressing (``TcImages``, the hidden slabs, the input slabs' passes, the
column blocks past hidden 256); these tests hold it against the images the
wrappers build, at hidden 48 (a padded tile), 256 and 512 (column blocks),
at encodings 60 + 36 and 700 + 36, for the mip features, in both dtypes, and
check that a wrapper refuses an image off the 16-byte boundary.
"""

from __future__ import annotations

import pytest
import torch

from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, MipNeRF, MipNeRFConfig
from nerf_tpu_torch.ops.kernels import classic_mlp, mip_mlp, tc_mlp

CPU = torch.device("cpu")
DTYPES = (torch.float32, torch.bfloat16)


def classic_packed(hidden: int, state: int):
    cfg = ClassicNeRFConfig(hidden_size=hidden, density_inputs=3 + state)
    model = ClassicNeRF(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    return classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))


def mip_packed(hidden: int):
    cfg = MipNeRFConfig(hidden_size=hidden)
    model = MipNeRF(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    return mip_mlp.pack_mip_params(model.mlp.requires_grad_(False))


def check_plan(packed, dtype):
    fwd, bwd = tc_mlp.tc_images(packed, backward=True, dtype=dtype)
    for img, backward in ((fwd, False), (bwd, True)):
        plan = tc_mlp.bulk_copies(packed, backward=backward, dtype=dtype)
        assert plan, "no copies"
        at = 0
        for offset, size in plan:
            assert offset == at, "the copies walk the image chunk after chunk"
            assert offset % tc_mlp.BULK_ALIGN == 0 and size % tc_mlp.BULK_ALIGN == 0
            assert size > 0
            at += size
        assert at == img.numel() * img.element_size(), "the copies cover the image"
        assert img.data_ptr() % tc_mlp.BULK_ALIGN == 0


# 60 + 36 is the full-width model's encodings (3 density inputs); 700 + 36
# the conditional trainer's with 32 state scalars (x encoding 700).
@pytest.mark.parametrize("dtype", DTYPES, ids=("float32", "bfloat16"))
@pytest.mark.parametrize("state", (0, 32), ids=("60+36", "700+36"))
@pytest.mark.parametrize("hidden", (48, 256, 512))
def test_classic_copies(hidden, state, dtype):
    packed = classic_packed(hidden, state)
    assert packed["w0"].shape[0] == (60 if state == 0 else 700)
    check_plan(packed, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=("float32", "bfloat16"))
@pytest.mark.parametrize("hidden", (48, 256))
def test_mip_copies(hidden, dtype):
    check_plan(mip_packed(hidden), dtype)


def test_chunk_sizes():
    """A chunk is kc k-values of every row: at hidden 256 a TF32 chunk (hi
    and lo of 16 values) is 32 KB, a bf16 one (32 values) 16 KB; the input
    cotangents' passes take 64 rows."""
    packed = classic_packed(256, 0)
    f32 = tc_mlp.bulk_copies(packed)
    bf16 = tc_mlp.bulk_copies(packed, dtype=torch.bfloat16)
    assert {s for _, s in f32} == {32768} and len(f32) == 4 + 4 + 3 + 9 * 16
    assert {s for _, s in bf16} == {16384} and len(bf16) == 2 + 2 + 2 + 9 * 8
    bwd = tc_mlp.bulk_copies(packed, backward=True)
    assert bwd[-1][1] == 2 * 64 * 16 * 4


def test_misaligned_image_refused():
    packed = classic_packed(64, 0)
    fwd, _ = tc_mlp.tc_images(packed)
    shifted = torch.empty(fwd.numel() + 1)[1:]
    shifted.copy_(fwd)
    tc_mlp.check_images("k", packed, fwd)
    with pytest.raises(ValueError, match="16-byte boundary"):
        tc_mlp.check_images("k", packed, shifted)
