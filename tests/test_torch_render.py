"""The port's renderer held against the JAX package on the CPU: every fine
branch of ``render_rays``, the tiled ``render_image``, the render CLI, and
the rule that the port never loads JAX or the JAX package.

Both models hold the same weights (``ClassicNeRF.init(PRNGKey(0))`` carried
across), and the port model is given the JAX package's frequency constants,
so what is compared is the algorithm; ``test_torch_ops`` bounds the
constants themselves (2 ulp).

The density head is set to a small positive density everywhere (bias 0.5,
weights x 0.05) in both models.  With the raw random init, relu zeroes the
density of about half the coarse intervals; the fine sampler then inverts a
cdf whose empty bins carry only its 1e-5 floor of mass, which magnifies a
1-ulp difference of the coarse weights into a shift of the fine samples of
~1e-2 of a bin (rgb differences near 1e-3).  With mass in every bin the
two packages agree to float32 rounding.
"""

import ast
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu import ClassicNeRF as JaxNeRF
from nerf_tpu import ClassicNeRFConfig as JaxConfig
from nerf_tpu import RenderConfig as JaxRender
from nerf_tpu.cli import render as jax_cli
from nerf_tpu.ops import encoding as jenc
from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, RenderConfig
from nerf_tpu_torch.cli import render as port_cli
from nerf_tpu_torch.data.scenes import spherical_poses
from nerf_tpu_torch.ops.kernels import _build
from nerf_tpu_torch.utils.pth_import import classic_state_dict_from_jax_params

REPO = Path(__file__).resolve().parents[1]

# rgb/acc and depth tolerances where the JAX side runs its Pallas kernels:
# the fused kernel sums the transmittance logs in another order (the JAX
# package's own parity test's tolerances).
TOL_KERNEL = dict(rtol=5e-4, atol=1e-4)
TOL_DEPTH_KERNEL = dict(rtol=1e-3, atol=1e-4)
# Without a kernel on either side: float32 matmul rounding in another order
# through ten LayerNorm'd layers.
TOL_PLAIN = dict(rtol=1e-4, atol=5e-5)


def make_models(use_pallas, **kwargs):
    kwargs = dict(dict(hidden_size=64, normalize_position=6.0), **kwargs)
    jmodel = JaxNeRF(JaxConfig(use_pallas=use_pallas, **kwargs))
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    params["density"] = {"w": params["density"]["w"] * np.float32(0.05),
                         "b": np.full_like(params["density"]["b"], 0.5)}
    cfg = ClassicNeRFConfig(use_pallas=use_pallas, **kwargs)
    model = ClassicNeRF(cfg, device="cpu")
    model.mlp.load_state_dict(classic_state_dict_from_jax_params(params))
    model.x_scales.copy_(torch.tensor(
        jenc.frequency_scales_np(cfg.x_positional_encoding_size, cfg.normalize_position)))
    if cfg.use_viewdirs:
        model.d_scales.copy_(torch.tensor(
            jenc.frequency_scales_np(cfg.d_positional_encoding_size, cfg.direction_bound)))
    return jmodel, params, model


def rays(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32) * 0.5,
            rng.normal(size=(n, 3)).astype(np.float32))


def render_both(use_pallas, fused_eval, render_kwargs, model_kwargs=None, states=None):
    jmodel, params, model = make_models(use_pallas, **(model_kwargs or {}))
    o, d = rays()
    rkw = dict(dict(num_coarse_samples=16, num_fine_samples=24, near=2.0, far=6.0,
                    randomly_sample=False, density_noise_std=0.0), **render_kwargs)
    jst = {} if states is None else dict(states_x=jnp.asarray(states[0]),
                                         states_d=jnp.asarray(states[1]))
    tst = {} if states is None else dict(states_x=torch.from_numpy(states[0]),
                                         states_d=torch.from_numpy(states[1]))
    ref = jmodel.render_rays(params, None, jnp.asarray(o), jnp.asarray(d),
                             JaxRender(**rkw), fused_eval=fused_eval, **jst)
    before = dict(_build.launch_counts)
    with torch.no_grad():
        out = model.render_rays(torch.from_numpy(o), torch.from_numpy(d),
                                RenderConfig(**rkw), fused_eval=fused_eval, **tst)
    assert dict(_build.launch_counts) == before  # CPU tensors launch nothing
    return ref, out


def assert_outputs_close(ref, out, kernel):
    tol = TOL_KERNEL if kernel else TOL_PLAIN
    assert out.rgb.shape == ref.rgb.shape
    np.testing.assert_allclose(out.rgb.numpy(), np.asarray(ref.rgb), **tol)
    np.testing.assert_allclose(out.acc.numpy(), np.asarray(ref.acc), **tol)
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(ref.depth),
                               **(TOL_DEPTH_KERNEL if kernel else TOL_PLAIN))


# (fused_eval, reuse_coarse_in_fine): the fused union eval, the unfused
# reuse branch and the re-evaluation of the merged set.
BRANCHES = {"fused_union": (True, True), "reuse": (False, True), "merged": (False, False)}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_render_rays_fine_branches(branch, use_pallas):
    fused_eval, reuse = BRANCHES[branch]
    ref, out = render_both(use_pallas, fused_eval, dict(reuse_coarse_in_fine=reuse))
    assert out.rgb.shape == (16, 2, 3)
    assert_outputs_close(ref, out, use_pallas)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_render_rays_white_background(use_pallas):
    ref, out = render_both(use_pallas, True, dict(white_background=True))
    assert_outputs_close(ref, out, use_pallas)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_render_rays_without_viewdirs(use_pallas):
    ref, out = render_both(use_pallas, True, {}, dict(use_viewdirs=False))
    assert_outputs_close(ref, out, use_pallas)


def test_render_rays_latent_conditioned_fused():
    rng = np.random.default_rng(5)
    states = (rng.normal(size=(16, 2)).astype(np.float32),
              rng.normal(size=(16, 1)).astype(np.float32))
    ref, out = render_both(True, True, {},
                           dict(hidden_size=32, density_inputs=5, color_inputs=4), states)
    assert_outputs_close(ref, out, True)


def test_render_rays_coarse_only():
    ref, out = render_both(False, False, dict(num_fine_samples=0))
    assert out.rgb.shape == (16, 1, 3)
    assert_outputs_close(ref, out, False)


def test_render_rays_random_needs_generator_and_is_seeded():
    _, _, model = make_models(False)
    o, d = (torch.from_numpy(v) for v in rays(8))
    render = RenderConfig(num_coarse_samples=8, num_fine_samples=8, density_noise_std=1.0)
    with torch.no_grad():
        with pytest.raises(ValueError):
            model.render_rays(o, d, render)
        a = model.render_rays(o, d, render, generator=torch.Generator().manual_seed(1))
        b = model.render_rays(o, d, render, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a.rgb, b.rgb, rtol=0, atol=0)
    assert torch.isfinite(a.rgb).all()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_render_image_tiled(use_pallas):
    jmodel, params, model = make_models(use_pallas)
    pose_o, pose_r = spherical_poses(1, radius=4.0, device="cpu")
    rkw = dict(num_coarse_samples=8, num_fine_samples=8, near=2.0, far=6.0,
               randomly_sample=False, density_noise_std=0.0, rays_per_tile=128)
    ref = jmodel.render_image(params, None, jnp.asarray(pose_o.numpy()),
                              jnp.asarray(pose_r.numpy()), 16, 16, 22.0, JaxRender(**rkw))
    img = model.render_image(pose_o, pose_r, 16, 16, 22.0, RenderConfig(**rkw))
    assert img.shape == (1, 16, 16, 3)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref),
                               **(TOL_KERNEL if use_pallas else TOL_PLAIN))


def read_png(path):
    """Decode the 8-bit RGB, filter-0 PNGs that ``write_png`` writes."""
    data = Path(path).read_bytes()
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            size = (int.from_bytes(body[4:8], "big"), int.from_bytes(body[:4], "big"))
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    h, w = size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert np.all(raw[:, 0] == 0)
    return raw[:, 1:].reshape(h, w, 3)


CLI_ARGS = ["--image-size", "8", "--focal", "11.0", "--num-views", "2",
            "--num-samples-per-ray", "8", "--num-fine-samples", "8"]


@pytest.fixture(scope="module")
def cli_reference(tmp_path_factory):
    """A .pth saved from a fresh full-width port model, and the JAX CLI's
    renders of it (its plain XLA path)."""
    from nerf_tpu_torch.models.mlp import ClassicMLP

    root = tmp_path_factory.mktemp("cli")
    mlp = ClassicMLP(ClassicNeRFConfig(normalize_position=6.0),
                     generator=torch.Generator().manual_seed(0), device="cpu")
    ckpt = str(root / "model.pth")
    torch.save(mlp.state_dict(), ckpt)
    jax_cli.main(["--checkpoint", ckpt, "--output-dir", str(root / "jax")] + CLI_ARGS)
    return ckpt, root / "jax"


@pytest.mark.parametrize("use_pallas", [False, True])
def test_render_cli_on_cpu_matches_jax_cli(cli_reference, tmp_path, use_pallas):
    ckpt, jax_dir = cli_reference
    port_cli.main(["--checkpoint", ckpt, "--output-dir", str(tmp_path), "--device", "cpu"]
                  + CLI_ARGS + (["--use-pallas"] if use_pallas else []))
    for name in ("view_000.png", "view_001.png"):
        ours = read_png(tmp_path / name).astype(int)
        ref = read_png(jax_dir / name).astype(int)
        # 8-bit quantisation of near-equal values: at most one level apart.
        assert np.abs(ours - ref).max() <= 1, name


def test_render_cli_renders_a_port_written_npz(tmp_path):
    # The full train state of a fresh full-width model, and the .pth of the
    # same weights: the two renders are the same PNGs.
    from nerf_tpu_torch.train import checkpoint, create_train_state

    model = ClassicNeRF(ClassicNeRFConfig(normalize_position=6.0),
                        generator=torch.Generator().manual_seed(1), device="cpu")
    npz = checkpoint.save_checkpoint(str(tmp_path), create_train_state(model))
    checkpoint.export_reference_pth(str(tmp_path / "nerf.pth"), model)
    for ckpt, out in ((npz, "npz"), (str(tmp_path / "nerf.pth"), "pth")):
        port_cli.main(["--checkpoint", ckpt, "--output-dir", str(tmp_path / out), "--device",
                       "cpu", "--use-pallas"] + CLI_ARGS)
    for name in ("view_000.png", "view_001.png"):
        image = read_png(tmp_path / "npz" / name)
        assert image.shape == (8, 8, 3) and image.std() > 0
        assert (tmp_path / "npz" / name).read_bytes() == (tmp_path / "pth" / name).read_bytes()


def test_port_and_chip_smoke_load_no_jax():
    smoke = REPO / "chip_smoke.py"
    imported = set()
    for node in ast.walk(ast.parse(smoke.read_text())):
        if isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.add(node.module)
    assert "nerf_tpu_torch" in {m.split(".")[0] for m in imported}
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "nerf_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(imported) + modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'nerf_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
