"""The row pass of the MLP backward rebuilt (``csrc/tc_mlp.cuh``'s
``bwd_rows_tc_kernel``, ``csrc/mip_mlp.cuh``'s ``mip_bwd_rows_tc_kernel``)
and K1-bwd fed the forward's chain, checked on the CPU.

* ``tc_mlp.colsum_groups``, the Python mirror of ``colsum``'s first stage
  over the row pass's partials (one row a 64-row tile): every tile summed
  exactly once, in order, in at most 64 groups, at the tails;
  ``tc_mlp.bwd_rows_smem``, the shared memory of both row kernels at every
  tile width in both dtypes, within what a block may opt in to.
* ``tc_mlp.bwd_rows_emulated``: the pass in float32 with 3xTF32 products,
  the row sums and the column sums in the kernels' order, against
  ``jax.vjp`` of the JAX package's ``_forward_chain`` (classic and mip, at
  hidden 32) for dpre, db, dg and dbeta.  Tolerance: normalised by the
  largest entry, atol 2e-4 (the JAX package's own gradient tests'); the
  largest seen is 5e-6 (the classic dpre, 3xTF32 against float32).
* ``ClassicMLPFunction``'s stored-chain route: bitwise the recomputing
  ``classic_mlp_bwd``, within the same tolerance of JAX's
  ``classic_mlp_pallas`` custom VJP in interpret mode (with the view
  branch), and the chain released after the backward.
* The backward image of the mip head's ``w_out`` (K = 54 padded to 64).
* The C interfaces of the stored-chain route, as ``_build`` binds them.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu import ClassicNeRF as JaxNeRF
from nerf_tpu import ClassicNeRFConfig as JaxConfig
from nerf_tpu.ops.pallas import fused_mip_mlp, fused_mlp
from nerf_tpu_torch import ClassicNeRFConfig
from nerf_tpu_torch.models.mlp import ClassicMLP
from nerf_tpu_torch.ops.kernels import _build, classic_mlp, tc_mlp
from nerf_tpu_torch.utils.pth_import import classic_state_dict_from_jax_params

GRAD_ATOL = 2e-4


@pytest.fixture(autouse=True)
def exact_ln_stats():
    """The two-pass LayerNorm statistics the port takes (the JAX package's
    own gradient tests pin them too)."""
    prev = fused_mlp._LN_STATS
    fused_mlp._LN_STATS = "twopass"
    yield
    fused_mlp._LN_STATS = prev


def assert_close_normalised(got, want, name):
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(np.asarray(got).reshape(want.shape) / scale, want / scale,
                               atol=GRAD_ATOL, err_msg=name)


# -- the partials' sum and the bytes ----------------------------------------


@pytest.mark.parametrize("rows", [1, 63, 64, 65, 1000, 131 * 64, 132 * 64 - 64, 132 * 64,
                                  132 * 64 + 64, 132 * 64 + 1, 200 * 64 + 17, 258_048])
@pytest.mark.parametrize("hidden", [32, 256, 512])
def test_colsum_groups_take_every_tile_once(rows, hidden):
    """The row pass writes a row of partials a 64-row tile at every width
    (past 256 too); colsum's groups cover them once, in order, contiguous,
    at most 64 of them, none empty."""
    tiles = -(-rows // 64)
    groups = tc_mlp.colsum_groups(rows)
    assert len(groups) == min(tiles, 64)
    assert [t for g in groups for t in g] == list(range(tiles))
    assert all(len(g) > 0 for g in groups)
    assert max(map(len, groups)) - min(map(len, groups)) <= 1
    if hidden > 256:  # the column blocks' scratch is per tile too
        assert tc_mlp.bwd_rows_smem(hidden) <= tc_mlp.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [32, 64, 128, 256])
def test_shared_memory_fits(hidden, dtype):
    """Both row kernels' bytes at every tile width (the classic one's at 1,
    3 and 16 colours), within the 232,448 a block may opt in to; at 256:
    207,872 (3 colours) and 206,848 (mip, any head width)."""
    for colors in (1, 3, 16):
        assert tc_mlp.bwd_rows_smem(hidden, dtype, colors) <= tc_mlp.SMEM_LIMIT
    assert tc_mlp.bwd_rows_smem(hidden, dtype, mip=True) <= tc_mlp.SMEM_LIMIT
    if hidden == 256:
        assert tc_mlp.bwd_rows_smem(hidden, dtype, 3) == 207_872
        assert tc_mlp.bwd_rows_smem(hidden, dtype, mip=True) == 206_848
    assert tc_mlp.bwd_rows_smem(512, dtype, 16) <= tc_mlp.SMEM_LIMIT


# -- the pass emulated, against JAX ------------------------------------------


class PerRowBias:
    """``w["b"]`` for ``_forward_chain`` with an additive per-row term e_i
    on each layer's pre-activation: ``w["b"][i][None, :]`` gives ``b_i +
    e_i``, so the cotangent of ``e_i`` is that layer's dpre."""

    def __init__(self, b, e):
        self.b, self.e = b, e

    def __getitem__(self, i):
        return _BiasRow(self.b[i], self.e[i])


class _BiasRow:
    def __init__(self, b, e):
        self.b, self.e = b, e

    def __getitem__(self, key):
        return self.b[key] + self.e


def random_weights(rng, hidden, layers, xe=0, de=0, colors=3, features=0, outputs=0):
    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(np.float32)

    out = {"b": rng.normal(scale=0.1, size=(layers, hidden)).astype(np.float32),
           "g": (1 + 0.2 * rng.normal(size=(layers, hidden))).astype(np.float32),
           "beta": rng.normal(scale=0.1, size=(layers, hidden)).astype(np.float32),
           "whh": w(layers - 1, hidden, hidden)}
    if features:
        out.update(w_in=w(features, hidden), w_out=w(hidden, outputs),
                   b_out=rng.normal(scale=0.1, size=(1, outputs)).astype(np.float32))
    else:
        out.update(w0=w(xe, hidden), wx=w(xe, hidden), w_dens=w(hidden, 1),
                   b_dens=np.zeros((1, 1), np.float32), w_col=w(hidden, colors),
                   b_col=np.zeros((1, colors), np.float32))
        if de:
            out["wd_in"] = w(de, hidden)
    return out


def jax_vjp(forward, w, g_out, layers, rows, hidden):
    """dpre of every layer and the gradients of b, g, beta by ``jax.vjp``."""
    e = jnp.zeros((layers, rows, hidden), jnp.float32)

    def f(b, g, beta, e):
        ww = {**{k: jnp.asarray(v) for k, v in w.items()}, "b": PerRowBias(b, e), "g": g,
              "beta": beta}
        return forward(ww)

    _, vjp = jax.vjp(f, jnp.asarray(w["b"]), jnp.asarray(w["g"]), jnp.asarray(w["beta"]), e)
    return vjp(g_out)


def torch_packed(w):
    out = {k: torch.from_numpy(v) for k, v in w.items()}
    for k in ("b_dens", "b_col", "b_out"):
        if k in out:
            out[k] = out[k].reshape(-1)
    return out


@pytest.mark.parametrize("view", [True, False], ids=["view", "no_view"])
def test_emulated_classic_bwd_rows_matches_jax_vjp(view):
    rng = np.random.default_rng(0)
    hidden, xe, de, rows = 32, 24, 12, 200
    layers = 10 if view else 8
    w = random_weights(rng, hidden, layers, xe, de if view else 0)
    x = rng.normal(size=(rows, xe)).astype(np.float32)
    d = rng.normal(size=(rows, de)).astype(np.float32) if view else None
    g_out = rng.normal(size=(rows, 4)).astype(np.float32)

    def forward(ww):
        _, dens, col = fused_mlp._forward_chain(jnp.asarray(x), None if d is None else
                                                jnp.asarray(d), ww, jnp.float32)
        return dens, col

    gb, gg, gbeta, gpre = jax_vjp(forward, w, (jnp.asarray(g_out[:, :1]),
                                               jnp.asarray(g_out[:, 1:])), layers, rows, hidden)
    packed = torch_packed(w)
    xhat, stats = tc_mlp.chain_plain(packed, torch.from_numpy(x),
                                     None if d is None else torch.from_numpy(d))
    got = tc_mlp.bwd_rows_emulated(packed, xhat, stats, torch.from_numpy(g_out))
    assert_close_normalised(got["dpre"].numpy(), gpre, "dpre")
    for name, want in (("b", gb), ("g", gg), ("beta", gbeta)):
        assert_close_normalised(got[name].numpy(), want, name)


def test_emulated_mip_bwd_rows_matches_jax_vjp():
    rng = np.random.default_rng(0)
    hidden, features, outputs, layers, rows = 32, 30, 54, 5, 200
    w = random_weights(rng, hidden, layers, features=features, outputs=outputs)
    x = rng.normal(size=(rows, features)).astype(np.float32)
    g_out = rng.normal(size=(rows, outputs)).astype(np.float32)

    def forward(ww):
        return fused_mip_mlp._forward_chain(jnp.asarray(x), ww, layers, jnp.float32)[1]

    gb, gg, gbeta, gpre = jax_vjp(forward, w, jnp.asarray(g_out), layers, rows, hidden)
    packed = torch_packed(w)
    xhat, stats = tc_mlp.chain_plain(packed, torch.from_numpy(x), mip=True)
    got = tc_mlp.bwd_rows_emulated(packed, xhat, stats, torch.from_numpy(g_out), mip=True)
    assert_close_normalised(got["dpre"].numpy(), gpre, "dpre")
    for name, want in (("b", gb), ("g", gg), ("beta", gbeta)):
        assert_close_normalised(got[name].numpy(), want, name)
    assert_close_normalised(got["b_out"].numpy(), g_out.sum(0), "b_out")


@pytest.mark.parametrize("rows", [1000, 64 * 64, 64 * 64 + 1, 200 * 64 + 17])
def test_column_sums_take_tile_then_colsum_order(rows):
    """``_col_sums`` (each tile's sum, then colsum's groups) equals the
    plain column sums to float32 rounding, and is the plain sum of the
    tiles' sums where there are at most 64 tiles (one group a tile)."""
    v = torch.from_numpy(np.random.default_rng(1).normal(size=(rows, 64)).astype(np.float32))
    got = tc_mlp._col_sums(v, rows)
    assert torch.allclose(got.double(), v.double().sum(0), atol=1e-3)
    if rows <= 64 * 64:
        tiles = torch.nn.functional.pad(v, (0, 0, 0, -rows % 64)).reshape(-1, 64, 64)
        assert torch.allclose(got, tiles.sum(1).sum(0), atol=1e-4)


# -- K1-bwd from the forward's chain -----------------------------------------


VARIANTS = {
    "view": dict(hidden_size=32),
    "no_view": dict(hidden_size=32, use_viewdirs=False),
}


def setup_variant(variant):
    kwargs = VARIANTS[variant]
    params = jax.tree_util.tree_map(
        np.asarray, JaxNeRF(JaxConfig(**kwargs)).init(jax.random.PRNGKey(0)))
    cfg = ClassicNeRFConfig(**kwargs)
    mlp = ClassicMLP(cfg, device="cpu")
    mlp.load_state_dict(classic_state_dict_from_jax_params(params))
    return cfg, params, classic_mlp.pack_classic_params(mlp.requires_grad_(False))


@pytest.mark.parametrize("input_grads", [True, False], ids=["dx", "no_dx"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_stored_chain_route_is_the_recompute_bitwise(variant, input_grads):
    cfg, params, packed = setup_variant(variant)
    rng = np.random.default_rng(0)
    n = 100
    x = torch.from_numpy(rng.normal(size=(n, cfg.x_encoding_dim)).astype(np.float32))
    d = (torch.from_numpy(rng.normal(size=(n, cfg.d_encoding_dim)).astype(np.float32))
         if cfg.use_viewdirs else None)
    g_out = torch.from_numpy(rng.normal(size=(n, 1 + cfg.color_outputs)).astype(np.float32))

    leaves = {k: v.clone().requires_grad_(True) for k, v in packed.items()}
    xs = x.clone().requires_grad_(input_grads)
    ds = None if d is None else d.clone().requires_grad_(input_grads)
    before = dict(_build.launch_counts)
    out = classic_mlp.classic_mlp_fwd(leaves, xs, ds)
    node = out.grad_fn
    assert isinstance(node.chain, dict) and "graph" in node.chain
    assert torch.equal(out.detach(), classic_mlp.classic_mlp_fwd_plain(packed, x, d))
    out.backward(g_out)
    assert node.chain is None, "the backward releases the chain"
    assert dict(_build.launch_counts) == before  # the plain versions launch nothing

    dx, dd, d_packed = classic_mlp.classic_mlp_bwd(packed, x, d, g_out, input_grads=input_grads)
    for k, v in d_packed.items():
        assert torch.equal(leaves[k].grad, v), k
    if input_grads:
        assert torch.equal(xs.grad, dx)
        if d is not None:
            assert torch.equal(ds.grad, dd)

    # Against JAX's custom VJP (its kernel recomputes the forward; the
    # recomputing route of both variants is held against it in
    # test_torch_train_kernels.py).
    if variant != "view":
        return
    want, gx = pallas_vjp(variant)
    for k, wv in want.items():
        assert_close_normalised(leaves[k].grad.numpy(), wv, k)
    if input_grads:
        assert_close_normalised(xs.grad.numpy(), gx, "dx")


@functools.lru_cache(maxsize=None)
def pallas_vjp(variant):
    """JAX's ``classic_mlp_pallas`` VJP in interpret mode on the stored-chain
    test's inputs: the packed weights' gradients and dx (once a variant)."""
    cfg, params, _ = setup_variant(variant)
    rng = np.random.default_rng(0)
    n = 100
    x = rng.normal(size=(n, cfg.x_encoding_dim)).astype(np.float32)
    d = rng.normal(size=(n, cfg.d_encoding_dim)).astype(np.float32) if cfg.use_viewdirs else None
    g_out = rng.normal(size=(n, 1 + cfg.color_outputs)).astype(np.float32)

    def f(p, x_, d_):
        return fused_mlp.classic_mlp_pallas(p, x_, d_, interpret=True)

    cot = (jnp.asarray(g_out[:, :1]), jnp.asarray(g_out[:, 1:]))
    if d is None:
        _, vjp = jax.vjp(lambda p, x_: f(p, x_, None), params, jnp.asarray(x))
        gp, gx = vjp(cot)
    else:
        _, vjp = jax.vjp(f, params, jnp.asarray(x), jnp.asarray(d))
        gp, gx, _ = vjp(cot)
    return {k: np.asarray(v) for k, v in fused_mlp.pack_classic_params(gp).items()}, gx


def test_direct_chain_call_and_second_backward():
    """``classic_mlp_fwd_chain`` then ``classic_mlp_bwd(..., chain=...)``
    directly (the chain kept by the caller, used twice); a chain kept
    without the encodings' gradients refuses to give them; a second
    backward through a retained graph, which finds no chain, recomputes."""
    cfg, _, packed = setup_variant("view")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(70, cfg.x_encoding_dim)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(70, cfg.d_encoding_dim)).astype(np.float32))
    g_out = torch.from_numpy(rng.normal(size=(70, 4)).astype(np.float32))
    ref = classic_mlp.classic_mlp_bwd(packed, x, d, g_out)
    out, chain = classic_mlp.classic_mlp_fwd_chain(packed, x, d)
    assert torch.equal(out, classic_mlp.classic_mlp_fwd_plain(packed, x, d))
    for _ in range(2):
        got = classic_mlp.classic_mlp_bwd(packed, x, d, g_out, chain=chain)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert all(torch.equal(got[2][k], ref[2][k]) for k in ref[2])
    _, frozen = classic_mlp.classic_mlp_fwd_chain(packed, x, d, input_grads=False)
    with pytest.raises(ValueError, match="chain"):
        classic_mlp.classic_mlp_bwd(packed, x, d, g_out, chain=frozen)

    leaves = {k: v.clone().requires_grad_(True) for k, v in packed.items()}
    y = classic_mlp.classic_mlp_fwd(leaves, x, d)
    y.backward(g_out, retain_graph=True)
    first = {k: v.grad.clone() for k, v in leaves.items()}
    for v in leaves.values():
        v.grad = None
    y.backward(g_out)
    assert all(torch.equal(leaves[k].grad, first[k]) for k in first)


# -- the mip head's backward image -------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_mip_head_image_padded_to_a_chunk(dtype):
    """The backward image ends with ``w_out [H, 54]`` as it stands, K
    zero-padded to 64 (the B operand of ``dh = g_out w_out^T``)."""
    rng = np.random.default_rng(3)
    w = torch_packed(random_weights(rng, 32, 5, features=30, outputs=54))
    fwd, bwd = tc_mlp.tc_images(w, backward=True, dtype=dtype)
    assert (fwd.numel(), bwd.numel()) == tc_mlp.image_numels(w, dtype)
    per = 1 if dtype == torch.bfloat16 else 2
    size = per * 32 * 64
    tail = bwd[-size:]
    assert torch.equal(tail, tc_mlp.head_image(w["w_out"], dtype))
    assert torch.equal(tail, tc_mlp.operand_image(w["w_out"], dtype))  # 54 -> 64 either way
    hi, lo = tc_mlp.operand_image_unpack(tail, 32, 54)
    assert hi.shape == (32, 64)
    if dtype == torch.bfloat16:
        assert torch.equal(hi[:, :54], w["w_out"].to(torch.bfloat16))
    else:
        want_hi, want_lo = tc_mlp.tf32_split(w["w_out"])
        assert torch.equal(hi[:, :54], want_hi) and torch.equal(lo[:, :54], want_lo)
        assert int((lo[:, 54:] != 0).sum()) == 0
    assert int((hi[:, 54:] != 0).sum()) == 0
    offsets = tc_mlp.bulk_copies(w, backward=True, dtype=dtype)
    assert offsets[-1][0] + offsets[-1][1] == bwd.numel() * bwd.element_size()


# -- the C interfaces ----------------------------------------------------------


def c_parameter_count(function: str) -> int:
    for src in _build.CSRC.glob("*.cu"):
        m = re.search(rf'extern "C" int {function}\(([^)]*)\)', src.read_text())
        if m:
            return len(m.group(1).split(","))
    raise AssertionError(f"no extern \"C\" {function} under {_build.CSRC}")


@pytest.mark.parametrize("function", ["classic_mlp_bwd", "classic_mlp_bwd_bf16",
                                      "classic_mlp_fwd_store", "classic_mlp_fwd_store_bf16"])
def test_stored_chain_interfaces_take_what_the_build_binds(function):
    assert len(_build.ARGTYPES[function]) == c_parameter_count(function)
    assert function in _build.FUNCTIONS[classic_mlp.BWD_NAME]
