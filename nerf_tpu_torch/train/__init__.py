"""Training stack: state, steps, metrics, checkpointing."""
from nerf_tpu_torch.train.state import TrainState, create_train_state
from nerf_tpu_torch.train.loop import Trainer, TrainDivergedError, make_train_step, make_sampling_train_step, make_multi_step_train_fn, make_fused_multi_step_train_fn, make_fused_loss_and_grads, supports_fused_train, make_loss_fn, evaluate
from nerf_tpu_torch.train.metrics import MetricsLogger, psnr, mse_to_psnr
from nerf_tpu_torch.train import checkpoint
