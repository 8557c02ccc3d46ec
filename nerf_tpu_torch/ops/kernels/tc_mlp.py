"""The tensor-core products of the MLP kernels: 3xTF32 on Hopper's
``wgmma``.

K1-fwd and K1-bwd (``classic_mlp``), K2 (``train_grads``), K3
(``fine_stage_train``), K4 (``union_eval``), K8-bwd (``point_mlp``), K9
(``mega_train``), K5-bwd (``mip_mlp``), K6 and K7 (``mip_train``) run their
hidden and encoding (or feature) products as three
TF32 products, ``hi(A) hi(B) + hi(A) lo(B) + lo(A) hi(B)``
with ``lo = x - hi``, into float32 accumulators (``csrc/tc_mlp.cuh``).  TF32
keeps 10 mantissa bits; the split keeps about 21, which is what float32
accuracy through ten LayerNorm'd layers needs.

TF32 ``wgmma`` takes both operands K-major, so every B operand is held as
``[N][K]`` (``N`` the output columns, ``K`` the summed index): the forward's
slabs as ``[out][in]`` (``nn.Linear``'s own layout, which
``pack_classic_params`` transposes away) and the backward's ``dh = dpre
W^T`` slabs as the packed ``[in][out]``.  The wrappers build each B operand
once per call, on the card, as an *operand image* (``operand_image``): K
padded with zeros to a multiple of 16 (the encodings 60 -> 64 and 36 -> 48:
16 TF32 values are one 64-byte row of the swizzle atom), split into hi and
lo by bit masking, and laid out chunk by chunk (16 k-values a chunk) as the
kernel copies it to shared memory: per chunk the hi block, then the lo
block, each ``[N][16]`` with the 16-byte group ``j`` of row ``n`` stored at
group ``j ^ ((n // 2) % 4)`` (the 64-byte swizzle of ``wgmma``'s
shared-memory operands, which keeps the tensor cores' reads of eight rows
off one bank).  The input cotangents of ``bwd_rows`` (``dx = dpre w0^T``
and the like) take the input slabs as packed, ``[in][out]``: their images
(``input_image``) pad the rows to a multiple of 64 and hold each pass of
``min(H, 64)`` rows, the columns one product computes, as its own image.

``tf32_split`` and ``tc_matmul`` are the plain emulation of the product
(the same masking, three float32 products); ``TcMatmul`` carries it through
autograd with the backward's two products emulated too, so the plain
versions of the kernels can run on the CPU with the card's arithmetic
(``matmul=tc_matmul_autograd``) and be held against their float32 selves.

``compute_dtype="bfloat16"`` (every kernel) runs each
product as ONE bf16 ``wgmma`` with float32 accumulation, the JAX package's
``_dot``, ``_dot_t`` and ``_dot_tn`` with a bf16 dtype: both operands rounded
to bfloat16 (to nearest even), the products summed in float32.
``bf16_matmul`` is its plain emulation and ``Bf16Matmul`` carries it through
autograd, rounding the incoming cotangent too before both backward
products (``dh = round(g) round(b)^T``, ``dW = round(a)^T round(g)``), as
JAX's custom VJP does.  The bf16 operand images (``operand_image(...,
dtype=torch.bfloat16)``) hold one bfloat16 array, no hi/lo pair: K padded
to a multiple of 32 (``BF16_CHUNK``: 32 bf16 values are one 64-byte row,
the same swizzle atom as 16 TF32 values), chunk by chunk ``[N][32]`` with
the 16-byte group ``j`` (8 values) of row ``n`` at ``j ^ ((n // 2) % 4)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

CHUNK = 16  # k-values per chunk of an operand image (kTcK in csrc/tc_mlp.cuh)
TILE_WIDTHS = (32, 64, 128, 256)  # the tiles' hidden widths (tile_width in csrc/classic_mlp.cuh)
COL_BLOCK = 256  # past the widest tile, the columns a product block computes (kColBlock)
BF16_CHUNK = 32  # k-values per chunk of a bfloat16 operand image (kTcKB)
TF32_MASK = -8192  # 0xffffe000 as an int32: sign, exponent and 10 mantissa bits


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``: ``hi`` is ``x`` truncated to TF32 and ``lo`` the rest
    (exact in float32) truncated to TF32, both by bit masking."""
    x = x.contiguous()
    hi = (x.view(torch.int32) & TF32_MASK).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & TF32_MASK).view(torch.float32)
    return hi, lo


def tc_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels compute it: three TF32 products summed in
    float32 (the ``lo lo`` term, about 2^-22 of the product, is dropped)."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


class TcMatmul(torch.autograd.Function):
    """``tc_matmul`` under autograd; the backward's products (``dh = g
    b^T``, ``dW = a^T g``) are 3xTF32 as well, as in the kernels'
    ``bwd_rows`` and ``wgrad`` passes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tc_matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return tc_matmul(g, b.t()), tc_matmul(a.t(), g)


def tc_matmul_autograd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return TcMatmul.apply(a, b)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (to nearest even) and widened back."""
    return x.to(torch.bfloat16).to(x.dtype)


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the bf16 kernels compute it: both operands rounded to
    bfloat16, the products (exact in float32) summed in float32."""
    return bf16_round(a) @ bf16_round(b)


class Bf16Matmul(torch.autograd.Function):
    """``bf16_matmul`` under autograd; the backward rounds the cotangent
    and both operands: ``dh = round(g) round(b)^T`` and ``dW = round(a)^T
    round(g)``, as in the kernels' ``bwd_rows`` and ``wgrad`` passes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return bf16_matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = bf16_round(g)
        return g @ bf16_round(b).t(), bf16_round(a).t() @ g


def bf16_matmul_autograd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return Bf16Matmul.apply(a, b)


def padded_hidden(hidden: int) -> int:
    """The width the kernels run a hidden width at (``csrc/tc_mlp.cuh``
    note 11): the smallest of ``TILE_WIDTHS`` that holds it, else the next
    multiple of ``COL_BLOCK`` (column blocks of 256)."""
    for width in TILE_WIDTHS:
        if hidden <= width:
            return width
    return -(-hidden // COL_BLOCK) * COL_BLOCK


# The dimensions of each packed slab (classic ``pack_classic_params`` or mip
# ``pack_mip_params``) that run along the hidden width.
HIDDEN_DIMS = {
    "w0": (1,), "wx": (1,), "wd_in": (1,), "w_in": (1,), "whh": (1, 2),
    "b": (1,), "g": (1,), "beta": (1,), "w_dens": (0,), "w_col": (0,), "w_out": (0,),
}


def hidden_of(packed) -> int:
    return packed["whh"].shape[-1]


def pad_packed(packed):
    """The packed weights as the kernels read them: every slab zero-padded
    along the hidden width to ``padded_hidden`` (weights, biases, LayerNorm
    scales and offsets alike, so the padded columns stay 0 through every
    layer; ``csrc/tc_mlp.cuh`` note 11).  The same dict where the width is
    an instantiated one."""
    hidden = hidden_of(packed)
    wide = padded_hidden(hidden)
    if wide == hidden:
        return packed
    out = {}
    for key, t in packed.items():
        pad = [0, 0] * t.dim()
        for dim in HIDDEN_DIMS.get(key, ()):
            pad[2 * (t.dim() - 1 - dim) + 1] = wide - hidden
        out[key] = F.pad(t, pad).contiguous()
    return out


def unpad_grads(d_padded, packed):
    """Gradients of ``pad_packed(packed)`` cut back to ``packed``'s shapes:
    the padded slots (all 0) are dropped."""
    if d_padded is None or hidden_of(packed) == padded_hidden(hidden_of(packed)):
        return d_padded
    return {k: v[tuple(slice(0, n) for n in packed[k].shape)] for k, v in d_padded.items()}


def chunk_of(dtype: torch.dtype) -> int:
    """k-values per chunk of an operand image of this dtype."""
    return BF16_CHUNK if dtype == torch.bfloat16 else CHUNK


def round_up_chunk(n: int, dtype: torch.dtype = torch.float32) -> int:
    return -(-n // chunk_of(dtype)) * chunk_of(dtype)


INPUT_PAD = 64  # rows of an input slab's image, padded (kTcInPad in csrc/tc_mlp.cuh)


def round_up_input(n: int) -> int:
    return -(-n // INPUT_PAD) * INPUT_PAD


def _swizzle_index(n: int, device) -> torch.Tensor:
    """For row ``r`` and 16-byte group ``j`` of a ``[n][16]`` block, the
    group it is stored at: ``j ^ ((r // 2) % 4)``."""
    r = torch.arange(n, device=device)[:, None]
    j = torch.arange(CHUNK // 4, device=device)[None, :]
    return j ^ ((r // 2) % 4)


def operand_image(b: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The operand image of ``b [..., N, K]`` (K-major, N a multiple of 8):
    ``[..., 2 N round_up_chunk(K)]`` floats, or with ``dtype`` bfloat16
    ``[..., N round_up_chunk(K, dtype)]`` bfloat16 values (see the module
    docstring)."""
    *lead, n, k = b.shape
    if n % 8:
        raise ValueError(f"operand_image: N must be a multiple of 8, got {n}")
    if dtype == torch.bfloat16:
        kp = round_up_chunk(k, dtype)
        v = F.pad(b, (0, kp - k)).to(torch.bfloat16)
        v = v.reshape(*lead, n, kp // BF16_CHUNK, 4, 8).movedim(-3, -4)  # [..., chunk, n, group, 8]
        dst = _swizzle_index(n, b.device)[:, :, None].expand(n, 4, 8)
        out = torch.empty_like(v).scatter_(-2, dst.expand_as(v), v)
        return out.reshape(*lead, -1)
    kp = round_up_chunk(k)
    hi, lo = tf32_split(F.pad(b, (0, kp - k)))
    hl = torch.stack([hi, lo], -3).reshape(*lead, 2, n, kp // CHUNK, CHUNK // 4, 4)
    hl = hl.movedim(-3, -5)  # [..., chunk, 2, n, group, 4]
    dst = _swizzle_index(n, b.device)[:, :, None].expand(n, CHUNK // 4, 4)
    out = torch.empty_like(hl).scatter_(-2, dst.expand_as(hl), hl)
    return out.reshape(*lead, -1)


def operand_image_unpack(img: torch.Tensor, n: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse of ``operand_image``: ``(hi, lo)``, each ``[..., N,
    round_up_chunk(K)]``; for a bfloat16 image ``(values, None)``."""
    *lead, _ = img.shape
    if img.dtype == torch.bfloat16:
        kp = round_up_chunk(k, img.dtype)
        v = img.reshape(*lead, kp // BF16_CHUNK, n, 4, 8)
        src = _swizzle_index(n, img.device)[:, :, None].expand(n, 4, 8)
        v = v.gather(-2, src.expand_as(v)).movedim(-4, -3).reshape(*lead, n, kp)
        return v, None
    kp = round_up_chunk(k)
    hl = img.reshape(*lead, kp // CHUNK, 2, n, CHUNK // 4, 4)
    src = _swizzle_index(n, img.device)[:, :, None].expand(n, CHUNK // 4, 4)
    hl = hl.gather(-2, src.expand_as(hl)).movedim(-5, -3).reshape(*lead, 2, n, kp)
    return hl[..., 0, :, :], hl[..., 1, :, :]


def operand_image_blocks(b: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``operand_image`` of ``b [..., N, K]`` with N past ``COL_BLOCK`` (a
    multiple of it) held as ``N / COL_BLOCK`` images of 256 rows, one a
    column block of the products (``csrc/tc_mlp.cuh`` note 11); up to 256
    the plain image.  ``[..., elements]`` either way."""
    *lead, n, k = b.shape
    if n <= COL_BLOCK:
        return operand_image(b, dtype)
    img = operand_image(b.reshape(*lead, n // COL_BLOCK, COL_BLOCK, k), dtype)
    return img.reshape(*lead, -1)


# The slabs on an encoding (classic) or the features (mip, ``w_in``), in
# the order the images hold them; ``whh`` follows.
INPUT_SLABS = ("w0", "wx", "wd_in", "w_in")


# The head slab whose input cotangent runs on the tensor cores (the mip
# ``w_out``; the classic heads' 1 + 3 outputs stay SIMT), after the input
# slabs in the backward image, its K (the outputs) zero-padded to a
# multiple of HEAD_K (``kHeadK`` in ``csrc/mip_mlp.cuh``: each product of
# the head takes 32 k-values).
HEAD_SLABS = ("w_out",)
HEAD_K = 32


def head_image(w: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The backward image of a head slab ``w [H, O]`` as it stands (K = O
    zero-padded to a multiple of ``HEAD_K``)."""
    return operand_image_blocks(F.pad(w, (0, -(-w.shape[1] // HEAD_K) * HEAD_K - w.shape[1])),
                                dtype)


def forward_slabs(packed) -> dict:
    """The packed weights' slabs as the forward's B operands, ``[out][in]``:
    the classic ``w0 [H, XE]``, ``wx [H, XE]``, ``wd_in [H, DE]`` (with the
    view branch), or the mip ``w_in [H, F]``; then ``whh [L - 1, H, H]``."""
    out = {k: packed[k].t() for k in INPUT_SLABS if k in packed}
    out["whh"] = packed["whh"].transpose(1, 2)
    return out


def input_image(w: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``bwd_rows``' B operand for the input cotangent ``dpre @ w^T`` of an
    input slab ``w [n, H]`` as packed (``[in][out]``, K-major for this
    product): the rows zero-padded to ``round_up_input(n)``, then each pass
    of ``min(H, 64)`` rows an operand image, ``[2 round_up_input(n) H]``
    floats (``tc_input_grad`` in ``csrc/tc_mlp.cuh``; with ``dtype``
    bfloat16 ``[round_up_input(n) H]`` bfloat16 values)."""
    n, hidden = w.shape
    rows = min(hidden, INPUT_PAD)
    padded = F.pad(w, (0, 0, 0, round_up_input(n) - n))
    return operand_image(padded.reshape(-1, rows, hidden), dtype).reshape(-1)


def tc_images(packed, backward: bool = False,
              dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The operand images a kernel reads, built on the weights' device:
    ``(forward, backward)``, for the classic weights
    (``classic_mlp.pack_classic_params``) or the mip ones
    (``mip_mlp.pack_mip_params``).  The forward images, in this order: the
    input slabs (``w0``, ``wx``, ``wd_in`` with the view branch; or
    ``w_in``), then each hidden slab (the order ``csrc/tc_mlp.cuh``'s
    ``TcImages`` and ``csrc/mip_mlp.cuh``'s ``MipImages`` read).  With
    ``backward`` also ``bwd_rows``' B operands: the hidden slabs (the
    packed ``[in][out]`` slabs), then the input slabs in the same order
    (``input_image``, for the input cotangents), then for the mip weights
    the head's ``w_out [H, O]`` as it stands, the B operand of the head's
    input cotangent ``dh = g_out w_out^T`` (``head_image``: K = O
    zero-padded to a multiple of 32, 54 -> 64); else ``None``.  ``dtype``
    bfloat16 builds the bf16 images of ``compute_dtype="bfloat16"``.  The
    weights are padded to the width the kernels run (``pad_packed``), and a
    slab past 256 outputs is held as its column blocks' images
    (``operand_image_blocks``)."""
    with torch.no_grad():
        packed = pad_packed(packed)
        slabs = forward_slabs(packed)
        fwd = [operand_image_blocks(slabs[k], dtype) for k in INPUT_SLABS if k in slabs]
        fwd.append(operand_image_blocks(slabs["whh"], dtype).reshape(-1))
        bwd = None
        if backward:
            bwd = torch.cat([operand_image_blocks(packed["whh"], dtype).reshape(-1)]
                            + [input_image(packed[k], dtype) for k in INPUT_SLABS if k in packed]
                            + [head_image(packed[k], dtype) for k in HEAD_SLABS
                               if k in packed])
        return torch.cat(fwd), bwd


def image_numels(packed, dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """Elements of the forward and the backward image ``tc_images(packed,
    backward=True, dtype=dtype)`` builds (floats, or bfloat16 values)."""
    hidden = padded_hidden(hidden_of(packed))
    widths = [packed[k].shape[0] for k in INPUT_SLABS if k in packed]
    heads = [-(-packed[k].shape[1] // HEAD_K) * HEAD_K for k in HEAD_SLABS if k in packed]
    per = 1 if dtype == torch.bfloat16 else 2  # hi and lo in TF32
    slabs = packed["whh"].shape[0] * per * hidden * hidden
    return (per * hidden * sum(round_up_chunk(w, dtype) for w in widths) + slabs,
            slabs + per * hidden * sum(round_up_input(w) for w in widths)
            + per * hidden * sum(round_up_chunk(o, dtype) for o in heads))


# The kernels copy each chunk of an image with one bulk copy
# (``cp.async.bulk``, ``csrc/tc_mlp.cuh``'s ``tc_gemm``), whose global
# address and size must be multiples of 16 bytes.
BULK_ALIGN = 16


def bulk_copies(packed, backward: bool = False,
                dtype: torch.dtype = torch.float32) -> list:
    """``(offset, size)`` in bytes of every chunk the kernels' producer
    copies from the forward image ``tc_images(packed, dtype=dtype)`` builds
    (with ``backward``, from the backward image), in image order: the
    addressing of ``csrc/tc_mlp.cuh``'s ``TcImages`` (``mip_mlp.cuh``'s
    ``MipImages``), the hidden slabs and ``tc_input_images``.  A chunk is
    ``kc`` k-values of every row of one operand image (``chunk_of``), hi
    and lo in TF32; a slab past 256 outputs is ``hp / 256`` images of 256
    rows (the column blocks), an input slab's backward image one image of
    ``min(hp, 64)`` rows a pass."""
    hidden = padded_hidden(hidden_of(packed))
    esize = 2 if dtype == torch.bfloat16 else 4
    per = 1 if dtype == torch.bfloat16 else 2
    kc = chunk_of(dtype)

    def image(n: int, k: int) -> list:
        return [per * n * kc * esize] * (round_up_chunk(k, dtype) // kc)

    def blocks(n: int, k: int) -> list:
        return [c for _ in range(max(1, n // COL_BLOCK)) for c in image(min(n, COL_BLOCK), k)]

    widths = [packed[k].shape[0] for k in INPUT_SLABS if k in packed]
    hidden_slabs = [c for _ in range(packed["whh"].shape[0]) for c in blocks(hidden, hidden)]
    if backward:
        rows = min(hidden, INPUT_PAD)
        sizes = hidden_slabs + [c for w in widths for _ in range(round_up_input(w) // rows)
                                for c in image(rows, hidden)]
        sizes += [c for k in HEAD_SLABS if k in packed
                  for c in blocks(hidden, -(-packed[k].shape[1] // HEAD_K) * HEAD_K)]
    else:
        sizes = [c for w in widths for c in blocks(hidden, w)] + hidden_slabs
    offsets, at = [], 0
    for size in sizes:
        offsets.append((at, size))
        at += size
    return offsets


def check_images(name: str, packed, tc_fwd: Optional[torch.Tensor],
                 tc_bwd: Optional[torch.Tensor] = None,
                 dtype: torch.dtype = torch.float32) -> None:
    """Raise a ``ValueError`` where operand images built beforehand are not
    the flat sizes ``tc_images(packed, dtype=dtype)`` gives them, or do not
    start on a ``BULK_ALIGN``-byte boundary (the wrappers' own checks take
    their device, type and layout)."""
    for key, img, n in zip(("tc_fwd", "tc_bwd"), (tc_fwd, tc_bwd), image_numels(packed, dtype)):
        if img is not None and tuple(img.shape) != (n,):
            raise ValueError(f"{name}: {key} must be tc_mlp.tc_images' [{n}] image of these "
                             f"weights, got {tuple(img.shape)}")
        if img is not None and img.data_ptr() % BULK_ALIGN:
            raise ValueError(f"{name}: {key} must start on a {BULK_ALIGN}-byte boundary (the "
                             f"kernels' bulk copies), got address {img.data_ptr():#x}")


# The weight-gradient pass (``csrc/tc_mlp.cuh``'s ``wgrad_tc_kernel``):
# 128 x 128 output tiles, the points cut into ``splits`` splits of
# ``wgrad_k_chunk`` points, each walked in chunks of 32 points, every
# chunk's products summed in a fresh accumulator and added to a float32 sum
# in chunk order.
WGRAD_TILE = 128  # kWT
WGRAD_CHUNK = 32  # kWgK
WGRAD_SPLIT_STEP = 16  # kWK: a split's points are a multiple of this
WGRAD_RAW_SLOTS = {torch.float32: 3, torch.bfloat16: 6}  # wg_raw_slots: raw chunks in flight
WGRAD_IMG_SLOTS = 2  # kWgImgSlots: operand images


def wgrad_k_chunk(points: int, splits: int) -> int:
    """The points of each split (``wgrad_k_chunk`` in
    ``csrc/classic_mlp_train.cuh``; the last split may hold fewer, or
    none)."""
    k = -(-points // splits)
    return -(-k // WGRAD_SPLIT_STEP) * WGRAD_SPLIT_STEP


class WgradProduct(NamedTuple):
    """One weight slab's product as the launchers hand it to the pass
    (``WProd``): ``dW [M][n] = A^T B`` with ``A`` the ``a`` rows ``[.][a_ld]``
    (``a_es`` bytes an element; point ``p`` reads row ``p``, or ``p // div``
    and, for ``p >= split > 0``, ``(p - split) // div2``) and ``B`` the ``b``
    rows ``[P][n]`` (float32).  ``a_base`` and ``b_base``: the operands'
    byte offsets from a 16-byte-aligned allocation; ``a_map`` and ``b_map``:
    the operand lies in the chain (xhat, dpre), which the launchers map for
    TMA as ``chain_rows`` rows of ``a_ld`` (``n``) floats."""

    slab: str
    a: str
    a_ld: int
    M: int
    n: int
    div: int
    relu: bool
    split: int
    div2: int
    a_es: int
    a_base: int
    b: str
    b_base: int
    a_map: bool
    b_map: bool
    chain_rows: int

    @property
    def tiles(self) -> int:
        return -(-self.M // WGRAD_TILE) * -(-self.n // WGRAD_TILE)


def classic_wgrad_products(xe: int, de: int, hidden: int, layers: int, points: int,
                           dtype: torch.dtype = torch.float32, d_div: int = 1,
                           d_split: int = 0, d_div2: int = 1) -> list:
    """``launch_mlp_backward``'s products (``csrc/classic_mlp_train.cuh``) at
    the padded hidden width ``hidden``: w0 and wx on the x encodings, wd on
    the view encodings (``de`` > 0; rows per ray with ``d_div``, K9's two
    stages with ``d_split``), then each hidden slab on the xhat rows of the
    layer below; the encodings in ``dtype``, the chain float32."""
    es = 2 if dtype == torch.bfloat16 else 4
    layer = points * hidden * 4  # bytes of one layer's rows of xhat or dpre
    rows = layers * points
    prods = [WgradProduct("w0", "x", xe, xe, hidden, 1, False, 0, 1, es, 0, "dpre0", 0,
                          False, True, rows),
             WgradProduct("wx", "x", xe, xe, hidden, 1, False, 0, 1, es, 0, "dpre4", 4 * layer,
                          False, True, rows)]
    if de:
        prods.append(WgradProduct("wd_in", "d", de, de, hidden, d_div, False, d_split, d_div2,
                                  es, 0, "dpre8", 8 * layer, False, True, rows))
    prods += [WgradProduct(f"whh{k}", f"xhat{k}", hidden, hidden, hidden, 1, False, 0, 1, 4,
                           k * layer, f"dpre{k + 1}", (k + 1) * layer, True, True, rows)
              for k in range(layers - 1)]
    return prods


def mip_wgrad_products(features: int, hidden: int, layers: int, outputs: int, points: int,
                       dtype: torch.dtype = torch.float32) -> list:
    """``launch_mip_backward``'s products (``csrc/mip_mlp.cuh``): w_in on the
    features, each hidden slab and the head on relu(xhat g + beta) of the
    layer below (the mip order), the head against the output cotangents."""
    es = 2 if dtype == torch.bfloat16 else 4
    layer = points * hidden * 4
    rows = layers * points
    prods = [WgradProduct("w_in", "x", features, features, hidden, 1, False, 0, 1, es, 0,
                          "dpre0", 0, False, True, rows)]
    prods += [WgradProduct(f"whh{k}", f"xhat{k}", hidden, hidden, hidden, 1, True, 0, 1, 4,
                           k * layer, f"dpre{k + 1}", (k + 1) * layer, True, True, rows)
              for k in range(layers - 1)]
    prods.append(WgradProduct("w_out", f"xhat{layers - 1}", hidden, hidden, outputs, 1, True, 0,
                              1, 4, (layers - 1) * layer, "gout", 0, True, False, rows))
    return prods


def wgrad_row(p: int, div: int, split: int, div2: int) -> int:
    """The row of A that point ``p`` reads (``WgOperand::row``)."""
    if div == 1:
        return p
    return (p - split) // div2 if 0 < split <= p else p // div


def wgrad_copy_plan(base: int, es: int, ld: int, col0: int, width: int, div: int, split: int,
                    div2: int, mapped: bool, p0: int, valid: int) -> Tuple[str, int, int, int]:
    """``(mode, ld, bytes, row0)`` of the chunk of ``valid`` points from
    ``p0`` of one operand (``WgOperand::plan``): ``"chunk"``, the tile
    spans the rows and the chunk's rows ``row0 ..`` are contiguous (a row a
    point, or per ray), one bulk copy, slot rows ``ld`` elements apart;
    ``"tma"``, the operand lies in a mapped chain buffer, one box of 32 rows
    x ``WGRAD_TILE`` floats from buffer row ``row0`` (the operand's first
    row in the buffer plus ``p0``); ``"rows"``, one bulk copy of the tile's
    columns a point; ``"direct"``, no copy (a row start, the tile's width or
    the chunk's bytes off the 16-byte rule), the transform reads device
    memory."""
    row_bytes = ld * es
    aligned = base % BULK_ALIGN == 0
    last = p0 + valid - 1
    straddle = div != 1 and 0 < split and p0 < split <= last
    if aligned and not straddle and col0 == 0 and width == ld:
        r0 = wgrad_row(p0, div, split, div2)
        nbytes = (wgrad_row(last, div, split, div2) - r0 + 1) * row_bytes
        if r0 * row_bytes % BULK_ALIGN == 0 and nbytes % BULK_ALIGN == 0:
            return "chunk", ld, nbytes, r0
    if mapped:
        return "tma", WGRAD_TILE, WGRAD_CHUNK * WGRAD_TILE * 4, base // row_bytes + p0
    if (aligned and row_bytes % BULK_ALIGN == 0 and col0 * es % BULK_ALIGN == 0
            and width * es % BULK_ALIGN == 0):
        return "rows", WGRAD_TILE, valid * width * es, 0
    return "direct", WGRAD_TILE, 0, 0


def wgrad_copies(products: list, points: int, splits: int) -> list:
    """The copier warp's copies of every chunk of every block of one launch
    of the pass over ``products`` (``wgrad_tc_kernel``'s ``wg_copy``): one
    dict a block, chunk and operand with the block's product index
    ``prod``, output tile ``(tm, tn)``, ``split``, ``chunk``, ``operand``
    (``"a"`` or ``"b"``), the chunk's first point ``p0`` and ``valid``
    points, the tile's first column ``col0`` and ``width``, the operand's
    element size ``es``, row stride ``ld``, ``base`` and row map (``div``,
    ``split_at``, ``div2``), the plan's ``mode``, the slot's row stride
    ``slot_ld``, ``bytes`` and ``row0``, and ``copies``: ``(slot offset,
    global byte offset, size)`` of each bulk copy (the global offset from
    the operand's allocation, its ``base`` included), or, for ``"tma"``,
    ``box``: ``(first row, first column, rows, columns)`` of the mapped
    buffer (``map_rows`` rows of ``ld`` floats)."""
    k_chunk = wgrad_k_chunk(points, splits)
    out = []
    for i, pr in enumerate(products):
        tiles_n = -(-pr.n // WGRAD_TILE)
        for t in range(pr.tiles):
            tm, tn = divmod(t, tiles_n)
            ops = {"a": (pr.a_base, pr.a_es, pr.a_ld, tm * WGRAD_TILE, pr.M, pr.div, pr.split,
                         pr.div2, pr.a_map),
                   "b": (pr.b_base, 4, pr.n, tn * WGRAD_TILE, pr.n, 1, 0, 1, pr.b_map)}
            for s in range(splits):
                begin, end = s * k_chunk, min(points, (s + 1) * k_chunk)
                for c, p0 in enumerate(range(begin, end, WGRAD_CHUNK)):
                    valid = min(WGRAD_CHUNK, end - p0)
                    for name, (base, es, ld, col0, size, div, split, div2, mapped) in ops.items():
                        width = min(WGRAD_TILE, size - col0)
                        mapped = mapped and es == 4 and div == 1 and ld % 4 == 0
                        mode, slot_ld, nbytes, row0 = wgrad_copy_plan(
                            base, es, ld, col0, width, div, split, div2, mapped, p0, valid)
                        box = None
                        if mode == "chunk":
                            copies = [(0, base + row0 * ld * es, nbytes)]
                        elif mode == "rows":
                            copies = [(pl * WGRAD_TILE * es,
                                       base + (wgrad_row(p0 + pl, div, split, div2) * ld + col0)
                                       * es, width * es) for pl in range(valid)]
                        else:
                            copies = []
                            if mode == "tma":
                                box = (row0, col0, WGRAD_CHUNK, WGRAD_TILE)
                        out.append(dict(prod=i, tm=tm, tn=tn, split=s, chunk=c, operand=name,
                                        p0=p0, valid=valid, col0=col0, width=width, es=es,
                                        ld=ld, base=base, div=div, split_at=split, div2=div2,
                                        mode=mode, slot_ld=slot_ld, bytes=nbytes, row0=row0,
                                        copies=copies, box=box, map_rows=pr.chain_rows))
    return out


def wgrad_emulated(a: torch.Tensor, b: torch.Tensor, splits: int, matmul=tc_matmul) -> torch.Tensor:
    """``a^T b`` summed as the pass sums it: each chunk of ``WGRAD_CHUNK``
    points of each split (``wgrad_k_chunk`` points) through ``matmul`` (the
    3xTF32 emulation by default, ``bf16_matmul`` for bf16) into a fresh
    partial, the partials added to the split's float32 sum in chunk order,
    and the splits' sums added in split order (``colsum``'s order at up to
    ``COLSUM_GROUPS`` splits).  ``a`` is A's rows expanded to one a point."""
    points = a.shape[0]
    k_chunk = wgrad_k_chunk(points, splits)
    total = torch.zeros(a.shape[1], b.shape[1], dtype=torch.float32, device=a.device)
    for s in range(splits):
        part = torch.zeros_like(total)
        for p0 in range(s * k_chunk, min(points, (s + 1) * k_chunk), WGRAD_CHUNK):
            p1 = min(p0 + WGRAD_CHUNK, (s + 1) * k_chunk, points)
            part = part + matmul(a[p0:p1].t(), b[p0:p1])
        total = total + part
    return total


# The row pass of the MLP backward (``csrc/tc_mlp.cuh``'s
# ``bwd_rows_tc_kernel``, ``csrc/mip_mlp.cuh``'s ``mip_bwd_rows_tc_kernel``):
# one block a 64-row tile, its column sums in the tile's row of the
# partials, which ``colsum`` sums.
TILE_ROWS = 64  # kTileRows
WARPS = 8  # kWarps: the consumer warps of a tile, 8 rows each
COLSUM_GROUPS = 64  # kColsumGroups: colsum's first stage
TC_STAGES = 4  # kTcStages
ENC_RING_FLOATS = TC_STAGES * TILE_ROWS * 20  # kEncRingFloats
SMEM_ALIGN = 1024  # kSmemAlign
SMEM_LIMIT = 232_448  # the shared memory a block may opt in to


def colsum_groups(rows: int) -> list:
    """The partials' rows (one a tile) that each group of ``colsum``'s
    first stage sums, in order (``colsum_kernel`` in
    ``csrc/classic_mlp_train.cuh``): at most 64 groups, group ``g`` the
    rows ``g T / G .. (g + 1) T / G - 1``; its second stage sums the
    groups in order."""
    tiles = -(-rows // TILE_ROWS)
    groups = min(tiles, COLSUM_GROUPS)
    return [range(g * tiles // groups, (g + 1) * tiles // groups) for g in range(groups)]


def bwd_rows_smem(hidden: int, dtype: torch.dtype = torch.float32, colors: int = 3,
                  mip: bool = False) -> int:
    """Bytes of shared memory of the row pass at a (padded) hidden width,
    ``bwd_rows_tc_smem`` / ``mip_bwd_rows_tc_smem``: the ring of B chunks
    (the same bytes in either dtype: a bf16 chunk fills half a TF32 slot),
    the activation tile ``[64][H + 4]`` (which also stages the mip head's
    output cotangents), the colsum scratch ``[8][H]`` (past 256 the
    encodings' ring in its place, the tile width 256), the classic heads'
    output cotangents ``[64][1 + colors]`` and the alignment slack.
    ``dtype`` does not change it."""
    width = min(hidden, COL_BLOCK)
    floats = TC_STAGES * 2 * width * CHUNK + TILE_ROWS * (width + 4)
    floats += ENC_RING_FLOATS if hidden > COL_BLOCK else WARPS * hidden
    if not mip:
        floats += TILE_ROWS * (1 + colors)
    return 4 * floats + SMEM_ALIGN


def _row_sums(v: torch.Tensor) -> torch.Tensor:
    """Each row's sum as ``layer_bwd`` takes it: lane ``l`` sums columns
    ``l + 32 j`` in ``j`` order, then ``warp_sum``'s butterfly (lanes xor
    16, 8, 4, 2, 1).  ``v [P, H]``, H a multiple of 32; returns ``[P]``."""
    lanes = torch.zeros(v.shape[0], 32, dtype=v.dtype, device=v.device)
    for j in range(v.shape[1] // 32):
        lanes = lanes + v[:, 32 * j:32 * j + 32]
    idx = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ o]
    return lanes[:, 0]


def _col_sums(v: torch.Tensor, rows: int) -> torch.Tensor:
    """The column sums of ``v [P, N]`` (zero past the rows) as the row pass
    and ``colsum`` take them: each warp's 8 rows in order, the 8 warps'
    partials in order (a tile's sum, its row of the partials), then
    ``colsum``'s two stages over the tiles' rows (``colsum_groups``)."""
    tiles = -(-rows // TILE_ROWS)
    v = torch.nn.functional.pad(v, (0, 0, 0, tiles * TILE_ROWS - rows))
    v = v.reshape(tiles, WARPS, TILE_ROWS // WARPS, -1)
    warp = torch.zeros_like(v[:, :, 0])
    for r in range(TILE_ROWS // WARPS):
        warp = warp + v[:, :, r]
    tile = torch.zeros_like(warp[:, 0])
    for w in range(WARPS):
        tile = tile + warp[:, w]
    out = torch.zeros_like(tile[0])
    for group in colsum_groups(rows):
        s = torch.zeros_like(tile[0])
        for t in group:
            s = s + tile[t]
        out = out + s
    return out


def bwd_rows_emulated(packed, xhat: torch.Tensor, stats: torch.Tensor, g_out: torch.Tensor,
                      mip: bool = False, matmul=tc_matmul) -> dict:
    """The row pass in float32 on the CPU, in the kernels' order: from the
    output cotangents ``g_out [P, O]`` and the chain the forward stored
    (``xhat [L, P, H]``, ``stats [L, P, 2]`` = (1/sigma, -mu/sigma)), the
    heads' input cotangent (classic: SIMT float32, the outputs in order;
    mip: ``matmul``), then per layer the LayerNorm and ReLU backward (the
    classic order, or ``mip``'s LayerNorm first) with the row sums as
    ``_row_sums`` takes them, and ``dh = dpre W^T`` through ``matmul`` (the
    3xTF32 emulation by default).  Returns ``dpre [L, P, H]`` and the
    column sums ``b``, ``g``, ``beta`` ``[L, H]`` (``_col_sums``: the tile,
    then ``colsum``'s order) and the mip ``b_out``.  The classic
    heads' weight gradients and the input cotangents are left out (the
    heads' dW is the same column sum of ``h * g_out``).  Unpadded widths:
    ``H`` a multiple of 32."""
    layers, rows, hidden = xhat.shape
    inv_h = torch.tensor(1.0 / hidden, dtype=torch.float32)
    g, beta = packed["g"], packed["beta"]
    dpre = torch.zeros_like(xhat)
    sums = {k: torch.zeros(layers, hidden) for k in ("b", "g", "beta")}
    if mip:
        acc = matmul(g_out, packed["w_out"].t())
        out = {"b_out": _col_sums(g_out, rows)}
    else:
        def head(cols, w, acc):
            for q in range(cols.shape[1]):
                acc = torch.addcmul(acc, cols[:, q:q + 1], w[:, q][None, :])
            return acc
        acc = head(g_out[:, 1:], packed["w_col"], torch.zeros(rows, hidden))
        if "wd_in" not in packed:
            acc = head(g_out[:, :1], packed["w_dens"], acc)
        out = {}
    for i in range(layers - 1, -1, -1):
        xh, inv, thr = xhat[i], stats[i, :, 0:1], stats[i, :, 1:2]
        dy = acc
        if mip:
            dy = torch.where(xh * g[i] + beta[i] > 0, acc, torch.zeros_like(acc))
        sums["beta"][i] = _col_sums(dy, rows)
        sums["g"][i] = _col_sums(dy * xh, rows)
        dxh = dy * g[i]
        m1 = (_row_sums(dxh) * inv_h)[:, None]
        m2 = (_row_sums(dxh * xh) * inv_h)[:, None]
        dp = inv * (dxh - m1 - xh * m2)
        if not mip:
            dp = torch.where(xh > thr, dp, torch.zeros_like(dp))
        dpre[i] = dp
        sums["b"][i] = _col_sums(dp, rows)
        if i == 0:
            break
        acc = matmul(dp, packed["whh"][i - 1].t())
        if not mip and i == 8:
            acc = torch.addcmul(acc, g_out[:, :1], packed["w_dens"][:, 0][None, :])
    return {"dpre": dpre, **sums, **out}


def chain_plain(packed, x: torch.Tensor, d: Optional[torch.Tensor] = None,
                mip: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain the forward stores, in float32 on the CPU: every layer's
    ``xhat [L, P, H]`` and ``(1/sigma, -mu/sigma) [L, P, 2]``, for the
    classic weights on encodings ``x`` (+ ``d``) or the mip ones on
    features ``x`` (``mip``)."""
    xh, st = [], []

    def norm(a):
        mu = a.mean(-1, keepdim=True)
        var = ((a - mu) ** 2).mean(-1, keepdim=True)
        inv = torch.rsqrt(var + 1e-5)
        xh.append((a - mu) * inv)
        st.append(torch.cat([inv, -mu * inv], -1))
        return xh[-1]

    layers = packed["b"].shape[0]
    if mip:
        h = x
        for i in range(layers):
            w = packed["w_in"] if i == 0 else packed["whh"][i - 1]
            h = torch.relu(norm(h @ w + packed["b"][i]) * packed["g"][i] + packed["beta"][i])
        return torch.stack(xh), torch.stack(st)

    def layer(i, pre):
        return norm(torch.relu(pre + packed["b"][i])) * packed["g"][i] + packed["beta"][i]

    whh = packed["whh"]
    h = layer(0, x @ packed["w0"])
    for i in range(1, layers):
        pre = h @ whh[i - 1]
        if i == 4:
            pre = pre + x @ packed["wx"]
        if i == 8:
            pre = pre + d @ packed["wd_in"]
        h = layer(i, pre)
    return torch.stack(xh), torch.stack(st)
