"""The weight-gradient pass's copy plan, grid and sum order, on the CPU.

``csrc/tc_mlp.cuh``'s ``wgrad_tc_kernel`` runs only on the card.  What
surrounds it is mirrored in ``ops/kernels/tc_mlp.py`` and held here:

* ``wgrad_copies``: the producer warp's bulk copies of every chunk of
  every block, from the product lists the classic and the mip launchers
  build (``classic_wgrad_products``, ``mip_wgrad_products``), at hidden 48,
  256 and 512, encodings 60 + 36 and 700 + 36, per-ray view rows, K9's two
  stages, the mip features 96 and 600, in both dtypes: every copy 16-byte
  aligned and sized, a chunk's copies covering exactly its points and the
  tile's columns where the transform reads them, and only rows that no
  bulk copy can bring left to the in-kernel path;
* ``classic_mlp.wgrad_splits``: the grid against the card's 132 SMs and
  the pass's one block an SM;
* ``wgrad_emulated``: 3xTF32 a chunk of 32 points, the float32 sum in chunk
  order, per split, the splits summed in ``colsum``'s order, against the
  weight gradients of the JAX package's plain classic MLP (``jax.vjp`` of
  ``fused_mlp._forward_chain``, no Pallas).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.ops.pallas import fused_mlp
from nerf_tpu_torch.ops.kernels import _build, classic_mlp, tc_mlp

SMS = 132  # an H100 SXM's SMs
SM_SHARED_BYTES = 233_472  # shared memory of one SM (228 KB)
BF16 = torch.bfloat16

# (name, products) of the launchers at small point counts: 300 points (not
# a multiple of 32) in 3 splits of 112.
POINTS, SPLITS = 300, 3
SC, SF = 4, 6  # K9's coarse and fine samples a ray: 300 = 30 rays x (4 + 6)


def classic_case(hidden, xe, de, dtype, rows="points"):
    hp = tc_mlp.padded_hidden(hidden)
    if rows == "per_ray":  # K3's view rows: one a ray of 10 samples
        kw = dict(d_div=10)
    elif rows == "k9":  # K9: coarse rows p // SC, fine rows (p - 30 SC) // SF
        kw = dict(d_div=SC, d_split=30 * SC, d_div2=SF)
    else:
        kw = {}
    return tc_mlp.classic_wgrad_products(xe, de, hp, 10, POINTS, dtype, **kw)


CASES = {
    **{f"classic_h{h}_{xe}+36_{rows}": (h, xe, rows)
       for h in (48, 256, 512) for xe in (60, 700) for rows in ("points", "per_ray", "k9")},
    "mip_f96": ("mip", 96, None),
    "mip_f600": ("mip", 600, None),
}


def products_of(case, dtype):
    h, width, rows = CASES[case]
    if h == "mip":
        return tc_mlp.mip_wgrad_products(width, 256, 5, 54, POINTS, dtype)
    return classic_case(h, width, 36, dtype, rows)


def element_offsets(rec, pl, cols):
    """Global byte offsets of point pl's elements at the tile's columns."""
    row = tc_mlp.wgrad_row(rec["p0"] + pl, rec["div"], rec["split_at"], rec["div2"])
    return rec["base"] + (row * rec["ld"] + rec["col0"] + cols) * rec["es"]


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_copies_are_aligned_and_cover_each_chunk(case, dtype):
    """Each bulk copy's slot offset, global offset and size are multiples
    of 16 bytes; a chunk's copies bring exactly its valid points' rows at
    the tile's columns, each element to the slot offset the consumers read
    (point pl, column c at (pl * slot_ld + c) * es), their bytes the ones
    the full barrier expects; a chunk left to the in-kernel path has no
    copy, and no bulk copy could have brought it."""
    records = tc_mlp.wgrad_copies(products_of(case, dtype), POINTS, SPLITS)
    assert records
    for rec in records:
        es, width, valid = rec["es"], rec["width"], rec["valid"]
        assert 0 < valid <= tc_mlp.WGRAD_CHUNK and 0 < width <= tc_mlp.WGRAD_TILE
        if rec["mode"] != "tma":
            assert sum(size for _, _, size in rec["copies"]) == rec["bytes"]
        for dst, src, size in rec["copies"]:
            assert dst % 16 == 0 and src % 16 == 0 and size % 16 == 0 and size > 0
            assert dst + size <= tc_mlp.WGRAD_CHUNK * tc_mlp.WGRAD_TILE * 4  # inside the slot
        cols = np.arange(width)
        if rec["mode"] == "direct":
            assert rec["copies"] == [] and rec["bytes"] == 0
            # A copy a point needs every row start and the width aligned; one
            # copy a chunk needs the chunk's rows contiguous, its start and
            # its bytes aligned.
            per_row = (rec["base"] % 16 == 0 and rec["ld"] * es % 16 == 0
                       and rec["col0"] * es % 16 == 0 and width * es % 16 == 0)
            contiguous = rec["div"] == 1 and rec["col0"] == 0 and width == rec["ld"]
            start = element_offsets(rec, 0, cols[:1])[0]
            whole = contiguous and start % 16 == 0 and valid * width * es % 16 == 0
            assert not per_row and not whole
            continue
        start = lambda pl: int(element_offsets(rec, pl, cols[:1])[0])  # noqa: E731
        if rec["mode"] == "rows":
            # Point pl's row of the tile's columns at slot row pl.
            assert rec["slot_ld"] == tc_mlp.WGRAD_TILE
            assert rec["copies"] == [(pl * tc_mlp.WGRAD_TILE * es, start(pl), width * es)
                                     for pl in range(valid)]
        elif rec["mode"] == "tma":
            # One box of the mapped chain ([map_rows][ld] floats, 16-byte
            # rows): point pl's row at box row pl, the tile's columns first.
            assert es == 4 and rec["div"] == 1 and rec["ld"] * 4 % 16 == 0 and rec["copies"] == []
            row0, col0, box_rows, box_cols = rec["box"]
            assert (box_rows, box_cols, rec["bytes"]) == (32, 128, 32 * 128 * 4)
            assert col0 == rec["col0"] and 0 <= row0 < rec["map_rows"]
            # (the operand's base is its offset in the buffer)
            assert all(((row0 + pl) * rec["ld"] + col0) * 4 == start(pl) for pl in range(valid))
        else:
            # The points' rows row0 .. (a row a point, or a ray's row for its
            # points), contiguous in device memory, in one copy: element
            # (pl, c) lands at ((row(p) - row0) * ld + c) * es.
            assert rec["mode"] == "chunk" and rec["col0"] == 0
            assert width == rec["ld"] == rec["slot_ld"]
            rows = [tc_mlp.wgrad_row(rec["p0"] + pl, rec["div"], rec["split_at"], rec["div2"])
                    for pl in range(valid)]
            assert rows[0] == rec["row0"] and rows == sorted(rows)
            assert rec["copies"] == [(0, rec["base"] + rec["row0"] * width * es,
                                      (rows[-1] - rows[0] + 1) * width * es)]
            assert all(start(pl) - rec["copies"][0][1] == (rows[pl] - rows[0]) * width * es
                       for pl in range(valid))


def test_copy_plans_of_the_cells():
    """Which plan each operand takes at the full-width model: the encodings
    and every operand of a tile that spans its rows (hidden 128, the mip
    head's 54 output cotangents) one bulk copy a chunk (K3's view rows one
    a chunk's rays), the 256-wide chain a TMA box; in bf16 the 60-wide x
    encodings a chunk at a time too (120-byte rows, every other one off the
    16-byte rule), and the per-ray view rows (72 bytes) read in the
    kernel."""
    def modes(products, points, splits, prod):
        recs = tc_mlp.wgrad_copies(products, points, splits)
        return {(r["operand"], r["mode"]) for r in recs
                if products[r["prod"]].slab == prod and r["valid"] == tc_mlp.WGRAD_CHUNK}

    k2 = tc_mlp.classic_wgrad_products(60, 36, 256, 10, 4096)
    assert modes(k2, 4096, 2, "w0") == {("a", "chunk"), ("b", "tma")}
    assert modes(k2, 4096, 2, "wd_in") == {("a", "chunk"), ("b", "tma")}
    assert modes(k2, 4096, 2, "whh3") == {("a", "tma"), ("b", "tma")}
    k3 = tc_mlp.classic_wgrad_products(60, 36, 128, 10, 4096, d_div=128)
    assert modes(k3, 4096, 2, "wd_in") == {("a", "chunk"), ("b", "chunk")}
    assert modes(k3, 4096, 2, "whh0") == {("a", "chunk"), ("b", "chunk")}
    k2b = tc_mlp.classic_wgrad_products(60, 36, 256, 10, 4096, BF16)
    assert modes(k2b, 4096, 2, "w0") == {("a", "chunk"), ("b", "tma")}
    k3b = tc_mlp.classic_wgrad_products(60, 36, 256, 10, 4096, BF16, d_div=128)
    assert modes(k3b, 4096, 2, "wd_in") == {("a", "direct"), ("b", "tma")}
    mip = tc_mlp.mip_wgrad_products(96, 256, 5, 54, 4096)
    assert modes(mip, 4096, 2, "w_out") == {("a", "tma"), ("b", "chunk")}


def test_k9_rows_straddling_the_stages():
    """K9's chunk that holds the last coarse and the first fine points
    copies each point's own ray row (p // SC before the split, (p - split)
    // SF after)."""
    prods = tc_mlp.classic_wgrad_products(60, 36, 256, 10, POINTS, d_div=SC, d_split=30 * SC,
                                          d_div2=SF)
    recs = [r for r in tc_mlp.wgrad_copies(prods, POINTS, 1)
            if prods[r["prod"]].slab == "wd_in" and r["operand"] == "a" and r["tn"] == 0]
    straddle = [r for r in recs if r["p0"] < 30 * SC < r["p0"] + r["valid"]]
    assert len(straddle) == 1 and straddle[0]["mode"] == "rows"
    rec = straddle[0]
    rows = [src // (36 * 4) for _, src, _ in rec["copies"]]
    want = [p // SC if p < 30 * SC else (p - 30 * SC) // SF
            for p in range(rec["p0"], rec["p0"] + rec["valid"])]
    assert rows == want


def mip_tiles(features, hidden, layers, outputs):
    th = -(-hidden // tc_mlp.WGRAD_TILE)
    return (th * -(-features // tc_mlp.WGRAD_TILE) + (layers - 1) * th * th
            + th * -(-outputs // tc_mlp.WGRAD_TILE))


@pytest.mark.parametrize("tiles,rows", [
    (sum(p.tiles for p in tc_mlp.classic_wgrad_products(60, 36, 256, 10, 1)), 262_144),
    (sum(p.tiles for p in tc_mlp.classic_wgrad_products(60, 36, 256, 10, 1)), 393_216),
    (mip_tiles(96, 256, 5, 54), 258_048),
    (sum(p.tiles for p in tc_mlp.classic_wgrad_products(700, 36, 512, 10, 1)), 65_536),
    (sum(p.tiles for p in tc_mlp.classic_wgrad_products(60, 36, 1024, 10, 1)), 262_144),
    (sum(p.tiles for p in tc_mlp.classic_wgrad_products(60, 36, 64, 10, 1)), 2_048),
])
def test_splits_fill_the_waves(tiles, rows):
    """The pass's blocks take 230,400 bytes of shared memory, so one runs
    on an SM at a time; the splits fill at most WGRAD_WAVES waves of the
    132 SMs, and one more split would pass them, unless 64 splits or one
    per 1024 rows stops them first.  The full-width model's 42 tiles keep
    25 splits (the partials' order, so the gradients' bits)."""
    smem = {dt: tc_mlp.WGRAD_RAW_SLOTS[dt] * 32_768 + tc_mlp.WGRAD_IMG_SLOTS * img + 1024
            for dt, img in ((torch.float32, 65_536), (BF16, 16_384))}
    assert set(smem.values()) == {230_400}
    assert all(s <= 232_448 < 2 * s and 2 * s > SM_SHARED_BYTES for s in smem.values())
    assert classic_mlp.WGRAD_BLOCKS_PER_SM == 1
    splits = classic_mlp.wgrad_splits(tiles, rows, SMS)
    per_wave = SMS * classic_mlp.WGRAD_BLOCKS_PER_SM
    assert 1 <= splits <= 64 and tiles * splits <= classic_mlp.WGRAD_WAVES * per_wave
    capped = splits == 64 or splits == -(-rows // 1024)
    assert capped or tiles * (splits + 1) > classic_mlp.WGRAD_WAVES * per_wave
    if tiles == 42 and rows >= 262_144:
        assert splits == 25


def test_emulated_sums_match_jax_weight_gradients():
    """The pass's sum order on the CPU (3xTF32 a chunk of 32 points, float32
    sums in chunk order, 2 splits) on the operands the classic backward
    hands it (the x and view encodings, each layer's output rebuilt as
    xhat g + beta, every layer's dpre) at hidden 32 over 100 points, against
    the weight gradients of the JAX package's plain classic MLP: relative
    to each slab's largest entry within 2e-5."""
    rng = np.random.default_rng(0)
    points, hidden, xe, de, colors = 100, 32, 60, 36, 3

    def u(*shape, scale=1.0):
        return (rng.uniform(-1, 1, shape) * scale).astype(np.float32)

    w = {"w0": u(xe, hidden, scale=0.3), "wx": u(xe, hidden, scale=0.3),
         "wd_in": u(de, hidden, scale=0.3), "whh": u(9, hidden, hidden, scale=0.3),
         "b": u(10, hidden, scale=0.1), "g": 1.0 + u(10, hidden, scale=0.1),
         "beta": u(10, hidden, scale=0.1), "w_dens": u(hidden, 1, scale=0.3),
         "b_dens": u(1, 1), "w_col": u(hidden, colors, scale=0.3), "b_col": u(1, colors)}
    x, d, g_out = u(points, xe), u(points, de), u(points, 1 + colors)

    prev = fused_mlp._LN_STATS
    fused_mlp._LN_STATS = "twopass"
    try:
        def objective(wj, xj, dj):
            _, dens, col = fused_mlp._forward_chain(xj, dj, wj, jnp.float32)
            return jnp.concatenate([dens, col], axis=-1)

        _, vjp = jax.vjp(objective, jax.tree_util.tree_map(jnp.asarray, w), x, d)
        want = jax.tree_util.tree_map(np.asarray, vjp(jnp.asarray(g_out))[0])
    finally:
        fused_mlp._LN_STATS = prev

    # The port's plain forward, each product's operand and its output's
    # cotangent (dpre) recorded.
    recorded = []

    def matmul(a, b):
        out = a @ b
        out.retain_grad()
        recorded.append((a, b, out))
        return out

    packed = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    out = classic_mlp.classic_mlp_fwd_plain(packed, torch.from_numpy(x), torch.from_numpy(d),
                                            matmul=matmul)
    out.backward(torch.from_numpy(g_out))
    slabs = {id(packed["w0"]): "w0", id(packed["wx"]): "wx", id(packed["wd_in"]): "wd_in"}
    got = {}
    for a, b, out in recorded:
        a = a.detach()
        key = slabs.get(id(b))
        if key is None:  # a hidden slab whh[k], a view of packed["whh"]
            k = next(i for i in range(9) if b.data_ptr() == packed["whh"][i].data_ptr())
            key = f"whh{k}"
        got[key] = tc_mlp.wgrad_emulated(a, out.grad, 2)
    assert len(got) == 12
    for key, value in got.items():
        ref = want["whh"][int(key[3:])] if key.startswith("whh") else want[key]
        scale = float(np.abs(ref).max())
        assert float(np.abs(value.numpy() - ref).max()) <= 2e-5 * scale, key


def test_emulated_sum_is_chunked_by_split():
    """The emulation's chunks start at each split's first point
    (wgrad_k_chunk, a multiple of 16): at 100 points in 2 splits of 64 and
    36, and in 25 splits of 16, its float32 sums stay within float32
    rounding of the float64 product."""
    gen = torch.Generator().manual_seed(1)
    a = torch.rand(100, 37, generator=gen, dtype=torch.float64) - 0.5
    b = torch.rand(100, 54, generator=gen, dtype=torch.float64) - 0.5
    assert tc_mlp.wgrad_k_chunk(100, 2) == 64 and tc_mlp.wgrad_k_chunk(100, 25) == 16
    exact = a.t() @ b
    for splits in (1, 2, 25):
        emulated = tc_mlp.wgrad_emulated(a.float(), b.float(), splits)
        assert emulated.dtype == torch.float32
        assert float((emulated.double() - exact).abs().max()) <= 1e-5


@pytest.mark.parametrize("function", ["tc_wgrad", "tc_wgrad_bf16"])
def test_tc_wgrad_takes_splits_and_rows(function):
    """The card tests' entry to the pass alone (``csrc/tc_product.cu``)
    takes the splits and the per-ray rows (div, split, div2), and the build
    binds as many arguments as the source declares."""
    src = (_build.CSRC / "tc_product.cu").read_text()
    params = re.search(rf'extern "C" int {function}\(([^)]*)\)', src).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names == ["a", "b", "out", "P", "M", "N", "splits", "div", "split", "div2", "stream"]
    assert len(_build.ARGTYPES[function]) == len(names)
    assert function in _build.FUNCTIONS["tc_product"]
