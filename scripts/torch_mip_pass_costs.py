"""What K6's and K7's passes cost by part of the mip chain, on the card.

    python scripts/torch_mip_pass_costs.py [--calls 5] [--out costs.json]
                                           [--compute-dtype bfloat16]

Runs K6 (``mip_train_grads``, seg weight 0.1, 4096 rays x 63 rows) and K7
(``mip_eval``, a 4000-ray tile of 63 rows) on random inputs under
``torch.profiler`` for three shapes of the full-width mip MLP (hidden 256,
96 IPE features, random weights from seed 0): the model's own (5 layers, 1
+ 3 + 50 outputs), one with a 5-wide head (1 class: 1 + 3 + 1) and one
with 3 layers.  Prints each pass's device ms a call (labelled as
``chip_smoke.PASSES`` names it) and two differences: the 54-wide head's
cost (the model's less the 5-wide head's: its float32 forward
``head_wide`` in the forward tile, its float32 input cotangent ``head_dh``
in ``bwd_rows``, its dW in ``wgrad``, the per-class compositing), and one
hidden layer's (the model's less the 3-layer one's, halved).  With
``--compute-dtype bfloat16`` the kernels run their bf16 entries on bf16
features and images (the head's operands rounded, still on the SIMT
cores).  The results are compared only within one call.  Exits non-zero
without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (pass labels, the card line)
from nerf_tpu_torch import MipNeRFConfig  # noqa: E402
from nerf_tpu_torch.models.mlp import MipMLP  # noqa: E402
from nerf_tpu_torch.ops import compositing  # noqa: E402
from nerf_tpu_torch.ops.kernels import mip_mlp, mip_train  # noqa: E402

SHAPES = {"model": dict(), "head_5": dict(segmentation_outputs=1),
          "layers_3": dict(num_hidden_layers=3)}
TRAIN_RAYS, EVAL_RAYS, ROWS = 4096, 4000, 63


def inputs(cfg, rays, device):
    gen = torch.Generator(device=device).manual_seed(5)

    def rand(*shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    points = torch.cumsum(rand(rays, ROWS, 3, lo=0.0, hi=1.0), dim=1)
    return dict(features=rand(rays, ROWS, cfg.feature_dim),
                dists=compositing.distances_from_points(points).contiguous(),
                t_mids=rand(rays, ROWS, lo=0.1, hi=60.0), noise=rand(rays, ROWS),
                pixels=rand(rays, cfg.color_outputs, lo=0.0, hi=1.0),
                labels=torch.randint(0, cfg.segmentation_outputs, (rays,), generator=gen,
                                     device=device))


def by_pass(fn, calls: int) -> dict:
    """Device ms a call of ``fn`` by kernel, labelled where
    ``chip_smoke.pass_label`` knows the kernel."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = defaultdict(float)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            label = chip_smoke.pass_label(evt.name) or "other (images, scratch, glue)"
            out[label] += evt.time_range.elapsed_us() / 1e3 / calls
    if not out:
        raise RuntimeError("the profiler recorded no device time")
    return dict(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--calls", type=int, default=5)
    p.add_argument("--out", help="also write the result as JSON to this file")
    p.add_argument("--compute-dtype", default="float32", choices=("float32", "bfloat16"))
    args = p.parse_args(argv)
    dtype = getattr(torch, args.compute_dtype)
    if not torch.cuda.is_available():
        print("torch_mip_pass_costs: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = chip_smoke.nvidia_smi("name,power.limit")
    print(card)
    result = {"card": card, "compute_dtype": args.compute_dtype}
    for name, kwargs in SHAPES.items():
        cfg = MipNeRFConfig(**kwargs)
        mlp = MipMLP(cfg, generator=torch.Generator().manual_seed(0), device=device)
        prepared = mip_mlp.prepare_weights(mlp.requires_grad_(False), backward=True, dtype=dtype)
        packed, tc_fwd, tc_bwd = prepared
        t = inputs(cfg, TRAIN_RAYS, device)
        e = inputs(cfg, EVAL_RAYS, device)
        t["features"], e["features"] = t["features"].to(dtype), e["features"].to(dtype)
        result[name] = {
            "K6": by_pass(lambda: mip_train.mip_train_grads(
                packed, t["features"], t["dists"], t["noise"], t["pixels"], t["labels"],
                cfg.color_outputs, 0.1, tc_fwd=tc_fwd, tc_bwd=tc_bwd), args.calls),
            "K7": by_pass(lambda: mip_train.mip_eval(
                packed, e["features"], e["dists"], e["t_mids"], None, cfg.color_outputs,
                tc_fwd=tc_fwd), args.calls),
        }
    for kernel in ("K6", "K7"):
        labels = sorted({k for s in SHAPES for k in result[s][kernel]})
        print(f"{kernel} ({args.compute_dtype}): device ms a call by pass "
              f"({', '.join(SHAPES)}; the 54-wide head; one hidden layer)")
        for label in labels + ["total"]:
            ms = {s: (sum(result[s][kernel].values()) if label == "total"
                      else result[s][kernel].get(label, 0.0)) for s in SHAPES}
            head = ms["model"] - ms["head_5"]
            layer = (ms["model"] - ms["layers_3"]) / 2
            print(f"  {label:60s} " + " ".join(f"{ms[s]:8.3f}" for s in SHAPES)
                  + f" {head:8.3f} {layer:8.3f}")
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
