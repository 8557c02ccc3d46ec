"""The plain path of the classic model on any device: a model's frame and
fused train steps with the five kernel wrappers of the classic main path
(K1-fwd, K1-bwd through ``ClassicMLPFunction``, K2, K3, K4) replaced by
their plain versions, the reference of the bf16 checks in
``chip_smoke.py`` and ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import contextlib

from nerf_tpu_torch.ops.kernels import (
    _build,
    classic_mlp,
    fine_stage_train,
    train_grads,
    union_eval,
)
from nerf_tpu_torch.train import make_fused_loss_and_grads


@contextlib.contextmanager
def plain_versions():
    """The classic main path's five wrappers replaced by their plain
    versions (the same arguments; bfloat16 encodings run the bf16
    emulation).  Raises if a kernel launched inside: a caller that reached
    a wrapper by another name would compare the kernel with itself.  The
    launch counts outside are kept."""
    k1 = classic_mlp.classic_mlp_fwd_plain
    k3 = fine_stage_train.fine_stage_train_plain
    k4 = union_eval.union_eval_plain
    patches = (
        (classic_mlp, "classic_mlp_fwd", lambda packed, x, d=None, *images: k1(packed, x, d)),
        (fine_stage_train, "classic_mlp_fwd", lambda packed, x, d=None, *images: k1(packed, x, d)),
        (union_eval, "union_eval", lambda *args, tc_fwd=None: k4(*args)),
        (fine_stage_train, "fine_stage_train", lambda *args, tc_fwd=None, tc_bwd=None: k3(*args)),
        (train_grads, "classic_train_grads", train_grads.classic_train_grads_plain),
    )
    originals = [(m, n, getattr(m, n)) for m, n, _ in patches]
    counts = dict(_build.launch_counts)
    _build.launch_counts.clear()
    for module, name, fn in patches:
        setattr(module, name, fn)
    try:
        yield
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
        launched = dict(_build.launch_counts)
        _build.launch_counts.clear()
        _build.launch_counts.update(counts)
    if launched:
        raise RuntimeError(f"the plain path launched kernels: {launched}")


def bf16_step_reference(model, render, batch, draws):
    """The plain step's loss and gradients (``make_fused_loss_and_grads``
    under ``plain_versions``)."""
    with plain_versions():
        loss, grads, _ = make_fused_loss_and_grads(model, render)(batch, draws)
    return loss, grads
