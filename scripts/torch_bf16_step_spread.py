"""How far apart float32-accurate bf16 computations of the same gradients
land, on the CPU: the port against the JAX package, and the JAX package
against itself.

    JAX_PLATFORMS=cpu python scripts/torch_bf16_step_spread.py

At hidden 64 (the fixtures of ``tests/test_torch_bf16.py``) prints the
relative L2 distance between

* the coarse-only fused step's bf16 gradients from the port
  (``nerf_tpu_torch.train.loop.make_fused_loss_and_grads``), from the JAX
  package's step jitted, and from the same JAX step run eagerly
  (``jax.disable_jit``), on 16 and 32 rays from seeds 0-3;
* K1's bf16 gradients (weights, ``dx``, ``dd``) from the port's plain
  version and from ``classic_mlp_pallas`` in interpret mode, on 512 rows
  from seeds 0-5;

and the cosine of bf16 gradients to float32 ones (the JAX package's bound
is 0.98): the coarse step's, the port's and JAX's against JAX's float32
step, and K3's (``fine_stage_train_pallas``, interpret mode) against the
port's float32 K3 at 4 and 16 rays.

``--k9`` prints K9's instead (about 3 min): the reuse step at 8 rays x
(8 + 16), hidden 64 (``tests/test_torch_pointmlp_mega_bf16.py``'s model),
on seeds 0-5 and both background colours: the port's plain bf16 step with
the JAX kernel's fine t-values held, from JAX's bf16 K9
(``fused_mega.mega_train_loss_and_grads``, interpret mode); JAX's bf16
reuse route (``fused_hier.reuse_train_loss_and_grads``) from JAX's K9;
and the cosine of the bf16 step's gradients to the float32 step's for
JAX's K9 and the port at 8 rays, the port alone at 32 and 64.

A float32 summation order moves a few activations or cotangents to the
other bf16 neighbour and the change travels through ten layers, so these
distances vary by inputs; JAX's eager and jitted runs differ by as much
as the port and JAX do.
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from test_torch_bf16 import (  # noqa: E402
    BF16,
    JaxRender,
    _module_with,
    batch_arrays,
    bf16_encodings,
    classic_mlp,
    fine_inputs,
    fine_stage_train,
    flat,
    fused_hier,
    fused_mlp,
    jax_packed,
    jloop,
    loop,
    make_models,
    rel_l2,
    sampling,
    setup_variant,
    t,
)

from nerf_tpu_torch import RenderConfig  # noqa: E402


def cosine(a, b) -> float:
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def coarse_step_spread() -> None:
    jmodel, params, model = make_models(True, compute_dtype="bfloat16")
    jmodel32, _, _ = make_models(True)
    render_kw = dict(num_coarse_samples=16, near=2.0, far=6.0, randomly_sample=False,
                     density_noise_std=0.0)
    fn = jloop.make_fused_loss_and_grads(jmodel, JaxRender(**render_kw))
    fn32 = jloop.make_fused_loss_and_grads(jmodel32, JaxRender(**render_kw))
    for n in (16, 32):
        for seed in range(4):
            b = batch_arrays(n=n, seed=seed)
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            _, jit, _ = fn(params, jax.random.PRNGKey(0), jb)
            _, f32, _ = fn32(params, jax.random.PRNGKey(0), jb)
            with jax.disable_jit():
                _, eager, _ = fn(params, jax.random.PRNGKey(0), jb)
            t_coarse = sampling.sample_linear(None, (n,), 16, 2.0, 6.0, randomly_sample=False,
                                              device="cpu")
            draws = sampling.StepDraws(t_coarse, torch.zeros(n, 16), None, None)
            _, grads, _ = loop.make_fused_loss_and_grads(model, RenderConfig(**render_kw))(
                {k: t(v) for k, v in b.items()}, draws)
            keys = jax_packed(jit)
            port = flat({k: v.detach().numpy() for k, v in classic_mlp.pack_classic_params(
                _module_with(model, grads)).items()}, keys)
            jit, eager = flat(jax_packed(jit), keys), flat(jax_packed(eager), keys)
            f32 = flat(jax_packed(f32), keys)
            print(f"coarse step, {n} rays, seed {seed}: port from JAX jitted "
                  f"{rel_l2(port, jit):.2e}, port from JAX eager {rel_l2(port, eager):.2e}, "
                  f"JAX eager from JAX jitted {rel_l2(eager, jit):.2e}; cosine to JAX's "
                  f"float32 step: port {cosine(port, f32):.4f}, JAX {cosine(jit, f32):.4f}",
                  flush=True)


def k1_spread() -> None:
    cfg, params, packed = setup_variant("view")
    for seed in range(6):
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(512, cfg.x_encoding_dim)).astype(np.float32)
        d = rng.normal(size=(512, cfg.d_encoding_dim)).astype(np.float32)
        g = rng.normal(size=(512, 1 + cfg.color_outputs)).astype(np.float32)
        _, vjp = jax.vjp(lambda p, x, d: fused_mlp.classic_mlp_pallas(
            p, x, d, compute_dtype=BF16, interpret=True),
            params, jnp.asarray(x).astype(BF16), jnp.asarray(d).astype(BF16))
        gp, gx, gd = vjp((jnp.asarray(g[:, :1]), jnp.asarray(g[:, 1:])))
        dx, dd, d_packed = classic_mlp.classic_mlp_bwd(packed, t(x, True), t(d, True), t(g))
        want = jax_packed(gp)
        got = flat({k: d_packed[k].numpy() for k in want}, want)
        print(f"K1 gradients, 512 rows, seed {seed}: port from JAX: weights "
              f"{rel_l2(got, flat(want, want)):.2e}, dx "
              f"{rel_l2(dx.float().numpy(), np.asarray(gx, np.float32)):.2e}, dd "
              f"{rel_l2(dd.float().numpy(), np.asarray(gd, np.float32)):.2e}", flush=True)


def k3_cosines() -> None:
    for variant in ("view", "latent"):
        cfg, params, packed = setup_variant(variant)
        for rays in (4, 16):
            a = fine_inputs(cfg, rays=rays, sc=8, sf=8)
            _, grads, _ = fused_hier.fine_stage_train_pallas(
                params, *[None if v is None else jnp.asarray(v) for v in a.values()],
                loss_weight=0.5, compute_dtype=BF16, interpret=True)
            _, port, _ = fine_stage_train.fine_stage_train(packed, **bf16_encodings(a),
                                                           loss_weight=0.5)
            _, f32, _ = fine_stage_train.fine_stage_train(
                packed, **{k: t(v) for k, v in a.items()}, loss_weight=0.5)
            f32 = {k: v.numpy() for k, v in f32.items()}
            port = flat({k: v.numpy() for k, v in port.items()}, f32)
            jax_bf16, f32 = flat(jax_packed(grads), f32), flat(f32, f32)
            print(f"K3 {variant}, {rays} rays: cosine to the float32 K3: port "
                  f"{cosine(port, f32):.4f}, JAX {cosine(jax_bf16, f32):.4f}", flush=True)


def k9_spread() -> None:
    from test_torch_pointmlp_mega_bf16 import render_kwargs
    from test_torch_train_reuse import jax_draws
    from test_torch_train_reuse import make_models as reuse_models

    from nerf_tpu.ops.pallas import fused_mega
    from nerf_tpu_torch.ops.kernels import mega_train

    jmodel, params, model = reuse_models(compute_dtype="bfloat16")
    jmodel32, _, model32 = reuse_models()
    packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
    model.requires_grad_(True)

    def port_step(m, kw, batch, draws):
        _, grads, _ = mega_train.mega_train_loss_and_grads(m, RenderConfig(**kw), batch, draws)
        return {k: v.detach().numpy() for k, v in classic_mlp.pack_classic_params(
            _module_with(m, grads)).items()}

    for white in (False, True):
        kw = render_kwargs(white)
        for seed in range(6):
            b = batch_arrays(n=8, seed=seed)
            key = jax.random.PRNGKey(seed)
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            _, grads_k9, aux = fused_mega.mega_train_loss_and_grads(
                jmodel, params, JaxRender(**kw), jb, key, interpret=True, emit_t_fine=True)
            _, grads_reuse, _ = fused_hier.reuse_train_loss_and_grads(jmodel, params,
                                                                      JaxRender(**kw), jb, key)
            inputs = mega_train.mega_inputs(model, {k: t(v) for k, v in b.items()},
                                            jax_draws(key, JaxRender(**kw), 8))
            _, _, held, _ = mega_train.mega_train_plain(
                packed, *inputs, white_background=white, t_fine=t(np.array(aux["t_fine"])))
            want = jax_packed(grads_k9)
            print(f"K9, 8 rays, white {white}, seed {seed}: the port (JAX's t-values held) "
                  f"from JAX's K9 {rel_l2(flat({k: v.numpy() for k, v in held.items()}, want), flat(want, want)):.2e}, "
                  f"JAX's reuse route from JAX's K9 "
                  f"{rel_l2(flat(jax_packed(grads_reuse), want), flat(want, want)):.2e}",
                  flush=True)
        for n in (8, 32, 64):
            b = batch_arrays(n=n)
            key = jax.random.PRNGKey(0)
            batch = {k: t(v) for k, v in b.items()}
            draws = jax_draws(key, JaxRender(**kw), n)
            f32 = port_step(model32, kw, batch, draws)
            port = flat(port_step(model, kw, batch, draws), f32)
            line = (f"K9 bf16 step, {n} rays, white {white}: cosine to the float32 step's, port "
                    f"{cosine(port, flat(f32, f32)):.5f}")
            if n == 8:
                jb = {k: jnp.asarray(v) for k, v in b.items()}
                got = [jax_packed(fused_mega.mega_train_loss_and_grads(
                    m, params, JaxRender(**kw), jb, key, interpret=True)[1])
                    for m in (jmodel, jmodel32)]
                line += f", JAX {cosine(flat(got[0], f32), flat(got[1], f32)):.5f}"
            print(line, flush=True)


if __name__ == "__main__":
    if "--k9" in sys.argv:
        k9_spread()
    else:
        coarse_step_spread()
        k1_spread()
        k3_cosines()
