"""Training loop: train steps, the fused-kernel step builders, evaluation
and the ``Trainer`` (counterpart of ``nerf_tpu/train/loop.py``).

* The loss is the reference's: MSE against the pixel broadcast over the
  stage axis, i.e. the mean over the coarse and fine stages.
* Every step takes its random draws made beforehand
  (``sampling.StepDraws``); the steps that draw for themselves take them
  from ``state.step_generator``, a function of (seed, step), so K chained
  steps equal K single steps and a resumed run continues the same
  trajectory.
* The mip family adds the log-space segmentation cross-entropy,
  ``segmentation_loss_weight`` times ``-mean log p(label)`` of the finest
  stage's composite, to the loss when the weight is positive.
* ``make_fused_loss_and_grads`` dispatches, as the JAX package does, to
  the mip step (K6 once), the reuse step (K1-fwd, K3, one K1-bwd), the
  coarse-only step (K2 once) or the re-evaluate step (K2 twice).
* PyTorch runs eagerly: the K-step functions are Python loops over the
  one-step function (the JAX package's ``lax.scan``).
* With a ``logging_dir`` the ``Trainer`` writes metrics, full-state
  checkpoints (``train/checkpoint.py``) and a watchdog heartbeat, and
  ``init_state`` resumes from the latest checkpoint.

Not ported yet: the ``mesh`` argument (data parallelism).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from nerf_tpu_torch.config import ClassicNeRFConfig, MipNeRFConfig, RenderConfig, TrainConfig
from nerf_tpu_torch.data.rays import RayBank
from nerf_tpu_torch.ops import compositing, sampling
from nerf_tpu_torch.ops.kernels import (
    classic_mlp,
    fine_stage_train,
    mip_mlp,
    mip_train,
    train_grads,
)
from nerf_tpu_torch.parallel.watchdog import Heartbeat
from nerf_tpu_torch.train import checkpoint as ckpt_lib
from nerf_tpu_torch.train.metrics import MetricsLogger, mse_to_psnr
from nerf_tpu_torch.train.state import TrainState, create_train_state, step_generator

Batch = Dict[str, torch.Tensor]
Aux = Dict[str, torch.Tensor]


class TrainDivergedError(RuntimeError):
    """Raised by ``Trainer.fit`` when a training chunk produces a
    non-finite loss, naming the step, instead of training on NaNs."""


def _check_finite_losses(losses, first_step: int) -> None:
    """Raise ``TrainDivergedError`` at the first non-finite loss of a
    chunk; ``first_step`` is the global step of the chunk's first loss."""
    losses = np.asarray(losses)
    finite = np.isfinite(losses)
    if finite.all():
        return
    bad = int(np.argmax(~finite))
    last_good = float(losses[bad - 1]) if bad else float("nan")
    raise TrainDivergedError(
        f"non-finite loss {losses[bad]!r} at step {first_step + bad} "
        f"(previous step's loss: {last_good:.6g})"
    )


def make_loss_fn(
    model, render: RenderConfig, segmentation_loss_weight: float = 0.0
) -> Callable[[Batch, sampling.StepDraws], Tuple]:
    """The per-batch loss ``loss_fn(batch, draws) -> (loss, aux)``: the MSE
    averaged over all stages (gradients reach the coarse and the fine
    pass), with ``aux["fine_mse"]`` the finest stage's MSE, plus
    ``segmentation_loss_weight`` times the segmentation cross-entropy of
    the finest stage when the weight is positive and the model has a
    segmentation head (``batch["labels"]``)."""

    def loss_fn(batch: Batch, draws: sampling.StepDraws):
        out = model.render_rays(
            batch["rays_o"], batch["rays_d"], render,
            states_x=batch.get("states_x"), states_d=batch.get("states_d"), draws=draws,
        )
        sq = (out.rgb - batch["pixels"][..., None, :]) ** 2
        rgb_loss = torch.mean(sq)
        total = rgb_loss
        aux = {"rgb_loss": rgb_loss, "fine_mse": torch.mean(sq[..., -1, :])}
        if segmentation_loss_weight > 0.0 and out.segmentation is not None:
            log_probs = out.segmentation[..., -1, :]
            seg_loss = -torch.mean(
                torch.take_along_dim(log_probs, batch["labels"][..., None], dim=-1)
            )
            total = total + segmentation_loss_weight * seg_loss
            aux["seg_loss"] = seg_loss
        aux["loss"] = total
        return total, aux

    return loss_fn


def draws_for_model(generator: Optional[torch.Generator], model, render: RenderConfig,
                    num_rays: int, device) -> sampling.StepDraws:
    """One step's draws for ``model``'s family (``sampling.draw_step``):
    log-bbox fenceposts for the mip family, linear ones for the classic."""
    cfg = getattr(model, "cfg", None)
    bbox = cfg.bbox_diagonal if isinstance(cfg, MipNeRFConfig) else None
    return sampling.draw_step(generator, render, num_rays, device, bbox_diagonal=bbox)


def _draws_for(state: TrainState, render: RenderConfig, batch: Batch,
               generator: Optional[torch.Generator] = None) -> sampling.StepDraws:
    device = batch["rays_o"].device
    gen = generator if generator is not None else step_generator(state, device)
    return draws_for_model(gen, state.model, render, batch["rays_o"].shape[0], device)


def _apply(state: TrainState, grads: Dict[str, torch.Tensor], aux: Aux) -> Aux:
    """One Adam update from ``grads`` (keyed by parameter name)."""
    for name, p in state.model.named_parameters():
        p.grad = grads[name]
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1
    aux = {k: v.detach() for k, v in aux.items()}
    aux["grad_norm"] = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads.values()])
    )
    return aux


def make_train_step(model, render: RenderConfig,
                    segmentation_loss_weight: float = 0.0) -> Callable:
    """One SGD step through the general (autograd) path:
    ``step(state, batch, draws=None) -> aux``, updating ``state`` in place.
    Without ``draws`` the step draws from ``step_generator(state)``."""
    loss_fn = make_loss_fn(model, render, segmentation_loss_weight)

    def step(state: TrainState, batch: Batch, draws: Optional[sampling.StepDraws] = None) -> Aux:
        draws = draws if draws is not None else _draws_for(state, render, batch)
        names, params = zip(*state.model.named_parameters())
        with torch.enable_grad():
            loss, aux = loss_fn(batch, draws)
        grads = torch.autograd.grad(loss, params)
        return _apply(state, dict(zip(names, grads)), aux)

    return step


def _sample(state: TrainState, bank: RayBank, batch_size: int, render: RenderConfig):
    """This step's batch and draws, both from ``step_generator(state)``."""
    gen = step_generator(state, bank.device)
    batch = bank.sample_batch(gen, batch_size)
    return batch, _draws_for(state, render, batch, gen)


def make_sampling_train_step(model, render: RenderConfig, bank: RayBank, batch_size: int,
                             segmentation_loss_weight: float = 0.0):
    """Train step with the batch gather from the device-resident bank:
    ``step(state) -> aux``."""
    inner = make_train_step(model, render, segmentation_loss_weight)

    def step(state: TrainState) -> Aux:
        return inner(state, *_sample(state, bank, batch_size, render))

    return step


def _multi_step(one_step: Callable, num_steps: int) -> Callable:
    def run(state: TrainState) -> Tuple[TrainState, Aux]:
        auxes = [one_step(state) for _ in range(num_steps)]
        return state, {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}

    return run


def make_multi_step_train_fn(model, render: RenderConfig, bank: RayBank, batch_size: int,
                             num_steps: int, segmentation_loss_weight: float = 0.0) -> Callable:
    """``num_steps`` general-path steps: ``run(state) -> (state, aux)``,
    each aux entry stacked to ``[num_steps]``."""
    return _multi_step(
        make_sampling_train_step(model, render, bank, batch_size, segmentation_loss_weight),
        num_steps,
    )


def supports_fused_train(model, render: RenderConfig, bank=None) -> bool:
    """True when the fused train kernels cover the configuration: the
    classic architecture family, with or without the view branch and at
    any latent width, and the HEAD mip model with its segmentation CE."""
    del render, bank
    cfg = getattr(model, "cfg", None)
    if isinstance(cfg, MipNeRFConfig):
        return mip_mlp.supports_mip_config(cfg)
    return isinstance(cfg, ClassicNeRFConfig) and classic_mlp.supports_classic_config(cfg)


def make_fused_loss_and_grads(model, render: RenderConfig,
                              segmentation_loss_weight: float = 0.0) -> Callable:
    """``fn(batch, draws) -> (loss, grads, aux)`` with every MLP
    evaluation in a kernel:

    * the HEAD mip model: K6 once, the MLP, compositing, MSE, log-space
      segmentation CE (``segmentation_loss_weight``) and the backward
      (``mip_train.mip_train_loss_and_grads``);
    * hierarchical ``reuse_coarse_in_fine=True`` (the default): K1-fwd on
      the coarse samples, K3 on the fine stage, one K1-bwd on the summed
      coarse cotangents (``fine_stage_train.reuse_train_loss_and_grads``);
    * coarse-only: K2 once;
    * hierarchical ``reuse_coarse_in_fine=False``: K2 on the coarse
      samples (its weights drive the resample), then K2 on the merged set.

    The classic kernels take their encodings in ``model.cfg.compute_dtype``
    (bfloat16 runs their bf16 kernels), as the JAX function casts them.
    ``grads`` is keyed by ``model.named_parameters()``.
    """
    if not supports_fused_train(model, render):
        raise ValueError(
            "fused train path requires the classic architecture family "
            "(ClassicNeRF, trunk_blocks=(4, 4), view_branch_depth=2 when use_viewdirs) "
            "or the HEAD MipNeRF"
        )
    if isinstance(model.cfg, MipNeRFConfig):
        def mip_fn(batch: Batch, draws: sampling.StepDraws):
            return mip_train.mip_train_loss_and_grads(
                model, render, batch, draws, segmentation_loss_weight
            )

        return mip_fn
    hierarchical = render.num_fine_samples > 0
    if hierarchical and render.reuse_coarse_in_fine:
        def reuse_fn(batch: Batch, draws: sampling.StepDraws):
            return fine_stage_train.reuse_train_loss_and_grads(model, render, batch, draws)

        return reuse_fn

    stage_w = 0.5 if hierarchical else 1.0
    dt = getattr(torch, model.cfg.compute_dtype)

    def stage_loss(packed, batch, t_vals, noise):
        x_enc, d_enc = model.encode_inputs_flat(
            batch["rays_o"], batch["rays_d"], t_vals, batch.get("states_x"), batch.get("states_d")
        )
        dists = compositing.distances_from_tvals(t_vals, batch["rays_d"])
        return train_grads.train_grads_loss(
            packed, x_enc.to(dt).contiguous(),
            None if d_enc is None else d_enc.to(dt).contiguous(),
            dists.contiguous(), noise.contiguous(), batch["pixels"].contiguous(),
            t_vals.shape[-1], render.white_background, stage_w,
        )

    def fn(batch: Batch, draws: sampling.StepDraws):
        names, params = zip(*model.named_parameters())
        with torch.enable_grad():
            packed = classic_mlp.pack_classic_params(model.mlp)
            loss, weights_c = stage_loss(packed, batch, draws.t_coarse, draws.noise_c)
            fine_mse = loss / stage_w
            if hierarchical:
                t_coarse = draws.t_coarse
                t_mids = 0.5 * (t_coarse[..., 1:] + t_coarse[..., :-1])
                t_fine = sampling.sample_pdf(
                    None, t_mids, weights_c[..., 1:-1], render.num_fine_samples,
                    randomly_sample=render.randomly_sample, u=draws.u,
                )
                t_all = sampling.merge_samples(t_coarse, t_fine)
                loss_f, _ = stage_loss(packed, batch, t_all, draws.noise_f)
                loss = loss + loss_f
                fine_mse = loss_f / stage_w
        grads = torch.autograd.grad(loss, params)
        loss = loss.detach()
        aux = {"loss": loss, "rgb_loss": loss, "fine_mse": fine_mse.detach()}
        return loss, dict(zip(names, grads)), aux

    return fn


def make_fused_train_step(model, render: RenderConfig,
                          segmentation_loss_weight: float = 0.0) -> Callable:
    """One step through ``make_fused_loss_and_grads``:
    ``step(state, batch, draws=None) -> aux``."""
    loss_and_grads = make_fused_loss_and_grads(model, render, segmentation_loss_weight)

    def step(state: TrainState, batch: Batch, draws: Optional[sampling.StepDraws] = None) -> Aux:
        draws = draws if draws is not None else _draws_for(state, render, batch)
        _, grads, aux = loss_and_grads(batch, draws)
        return _apply(state, grads, aux)

    return step


def make_fused_multi_step_train_fn(model, render: RenderConfig, bank: RayBank,
                                   batch_size: int, num_steps: int,
                                   segmentation_loss_weight: float = 0.0) -> Callable:
    """``num_steps`` fused steps, each batch drawn from the bank:
    ``run(state) -> (state, aux)``."""
    inner = make_fused_train_step(model, render, segmentation_loss_weight)

    def one_step(state: TrainState) -> Aux:
        return inner(state, *_sample(state, bank, batch_size, render))

    return _multi_step(one_step, num_steps)


@torch.no_grad()
def evaluate(
    model,
    scene,
    render: RenderConfig,
    view_index: int = -1,
    states_x: Optional[torch.Tensor] = None,
    states_d: Optional[torch.Tensor] = None,
):
    """Render one holdout view deterministically (no jitter, no density
    noise) and return ``(image [1, H, W, 3], psnr)``; of the mip family's
    ``(rgb, seg)`` the rgb."""
    eval_render = dataclasses.replace(render, randomly_sample=False, density_noise_std=0.0)
    b, h, w = scene.images.shape[:3]
    idx = view_index % b
    if states_x is None:
        states_x = getattr(scene, "states_x", None)
    if states_d is None:
        states_d = getattr(scene, "states_d", None)
    out = model.render_image(
        scene.pose_o[idx:idx + 1], scene.pose_r[idx:idx + 1], h, w, scene.focal, eval_render,
        states_x=None if states_x is None else states_x[idx:idx + 1],
        states_d=None if states_d is None else states_d[idx:idx + 1],
    )
    image = out[0] if isinstance(out, tuple) else out
    gt = scene.images[idx:idx + 1]
    return image, mse_to_psnr(torch.mean((image - gt) ** 2))


class Trainer:
    """End-to-end trainer: device-resident data, chunks of steps
    between log, eval and checkpoint boundaries, the fused kernels when
    ``model.cfg.use_pallas`` and the configuration allows them, periodic
    eval, full-state checkpoints and resume."""

    def __init__(
        self,
        model,
        render: RenderConfig,
        train: TrainConfig,
        logging_dir: Optional[str] = None,
        segmentation_loss_weight: float = 0.0,
        optimizer: Optional[torch.optim.Optimizer] = None,
    ):
        self.model = model
        self.render = render
        self.train_cfg = train
        self.logging_dir = logging_dir
        self.seg_weight = segmentation_loss_weight
        self.optimizer = optimizer
        self.metrics = MetricsLogger(logging_dir)

    def init_state(self, resume: bool = True) -> TrainState:
        """Weights drawn anew from ``train.seed`` and a fresh Adam; with
        ``resume`` and a logging dir, the latest checkpoint there
        restored into them."""
        self.model.mlp.reset_parameters(torch.Generator().manual_seed(self.train_cfg.seed))
        state = create_train_state(
            self.model, self.train_cfg.learning_rate, self.train_cfg.seed, self.optimizer
        )
        if resume and self.logging_dir:
            ckpt_lib.restore_latest(self.logging_dir, state)
        return state

    def _make_run_fn(self, bank: RayBank, num_steps: int, fused: bool) -> Callable:
        maker = make_fused_multi_step_train_fn if fused else make_multi_step_train_fn
        return maker(self.model, self.render, bank, self.train_cfg.batch_size, num_steps,
                     self.seg_weight)

    def fit(
        self,
        bank: RayBank,
        eval_scene=None,
        num_steps: Optional[int] = None,
        state: Optional[TrainState] = None,
        eval_view: int = -1,
    ) -> TrainState:
        """Train to ``num_steps`` in chunks between the log, eval and
        checkpoint boundaries, through the fused kernels when the
        configuration allows (``cfg.use_pallas``).  The draws of each step
        depend on (seed, step) only, so chunking does not change the
        trajectory, and a run resumed from any checkpoint continues it."""
        cfg = self.train_cfg
        num_steps = num_steps or cfg.num_steps
        state = state if state is not None else self.init_state()
        # The mip kernel carries the segmentation CE; the classic family
        # has no segmentation head, so a seg weight keeps it off the fused
        # path, as in the JAX package.
        fused = (
            (self.seg_weight == 0.0 or isinstance(self.model.cfg, MipNeRFConfig))
            and bool(getattr(self.model.cfg, "use_pallas", False))
            and supports_fused_train(self.model, self.render, bank)
        )
        chunk = math.gcd(math.gcd(cfg.log_interval, cfg.eval_interval), cfg.checkpoint_interval)

        def run_chunk(state, k):
            return self._make_run_fn(bank, k, fused)(state)

        # Liveness and progress beacon for the watchdog's supervisor
        # (parallel/watchdog.py), stepped at every chunk boundary.
        heartbeat = None
        if self.logging_dir:
            heartbeat = Heartbeat(self.logging_dir).start()
        try:
            return self._fit_loop(bank, eval_scene, num_steps, state, eval_view, chunk,
                                  run_chunk, heartbeat)
        finally:
            # A beat surviving a failed fit would hide the failure from
            # the supervisor.
            if heartbeat is not None:
                heartbeat.stop()

    def _fit_loop(self, bank, eval_scene, num_steps, state, eval_view, chunk,
                  run_chunk, heartbeat) -> TrainState:
        cfg = self.train_cfg
        last_t = time.time()
        step = int(state.step)
        while step < num_steps:
            boundary = min(num_steps, (step // chunk + 1) * chunk)
            k = boundary - step
            state, aux = run_chunk(state, k)
            step = boundary
            if heartbeat is not None:
                heartbeat.update(step)
            aux = {key: v.cpu().numpy() for key, v in aux.items()}
            _check_finite_losses(aux["loss"], step - k + 1)
            if step % cfg.log_interval == 0 or step == num_steps:
                now = time.time()
                record = dict(
                    loss=float(aux["loss"][-1]),
                    train_psnr=mse_to_psnr(float(aux["fine_mse"][-1])),
                    rays_per_s=cfg.batch_size * k / max(now - last_t, 1e-9),
                )
                if eval_scene is not None and (
                    step % cfg.eval_interval == 0 or step == num_steps
                ):
                    _, value = evaluate(self.model, eval_scene, self.render, eval_view)
                    record["psnr"] = float(value)
                self.metrics.log(step, **record)
            if self.logging_dir and step % cfg.checkpoint_interval == 0:
                ckpt_lib.save_checkpoint(self.logging_dir, state)
            last_t = time.time()
        if self.logging_dir:
            ckpt_lib.save_checkpoint(self.logging_dir, state)
            self.metrics.save_npy_dumps()
        return state
