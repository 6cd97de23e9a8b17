#!/usr/bin/env python3
"""Where the time of the PyTorch port's train step goes, on one GPU.

    python scripts/profile_torch_train.py [--batch 8] [--iters 5] [--out DIR]

Builds the training configuration of ``chip_smoke.py`` (Faster R-CNN
ResNet-101 v1, 80 classes, bf16, 608x800 canvas, base-config training
defaults, clip by norm, momentum 0.9 at 1e-4, random weights from a seed),
uploads one synthetic batch with 4 ground-truth boxes per image, and then:

* times the whole train step (``train.make_train_step``) with CUDA events;
* times its parts: the forward by stage (trunk, RPN head, proposals with
  kernel K1, target assignment, ROI crop+pool with kernel K2, block4 tail,
  RCNN head), the loss, the backward (kernel K3 inside) and the optimizer
  update;
* traces a few steps with ``torch.profiler`` and prints the device time by
  kernel and the device's busy share of the traced wall time.

``--out`` also writes the Chrome trace there. Needs a CUDA device.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from chip_smoke import (  # noqa: E402
    BUILD, CANVAS, SEED, random_gt, train_config,
)
from profile_torch_serve import STAGE_FUNCTIONS, StageTimer  # noqa: E402
from luminoth_tpu_torch.models import get_model  # noqa: E402
from luminoth_tpu_torch.models.fasterrcnn import model as model_module  # noqa: E402
from luminoth_tpu_torch.train import make_train_step, step_generator  # noqa: E402
from luminoth_tpu_torch.utils.config import get_config  # noqa: E402
from luminoth_tpu_torch.utils.predicting import model_dtype  # noqa: E402
from luminoth_tpu_torch.utils.training import (  # noqa: E402
    build_trainable_mask,
    build_weight_decay_coefficients,
    get_optimizer,
    l2_regularization_loss,
)
from luminoth_tpu_torch.utils.weights import (  # noqa: E402
    init_variables,
    load_flax_variables,
)

TRAIN_STAGE_FUNCTIONS = STAGE_FUNCTIONS + (
    "rpn_target_assign", "rcnn_target_assign",
)


def events():
    return [torch.cuda.Event(enable_timing=True) for _ in range(2)]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: no CUDA device is available")

    device = torch.device("cuda", 0)
    config = get_config(train_config(
        os.path.join(BUILD, "profile_train.yml"), 80, "bfloat16", CANVAS, {}))
    model = get_model("fasterrcnn")(config, dtype=model_dtype(config))
    model = load_flax_variables(model, init_variables(config, SEED))
    model = model.to(device)
    mask = build_trainable_mask(model, config.model)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    params = dict(model.named_parameters())
    decay = build_weight_decay_coefficients(model, config.model)
    optimizer, _ = get_optimizer(config.train, params, mask, decay)
    reg_fn = lambda: l2_regularization_loss(params, decay)  # noqa: E731
    train_step = make_train_step(model, optimizer, reg_fn=reg_fn)

    rng = np.random.default_rng(SEED)
    batch = {
        "image": torch.from_numpy(rng.integers(
            0, 256, (args.batch, CANVAS[0], CANVAS[1], 3), dtype=np.uint8
        )).to(device),
        "gt_boxes": torch.from_numpy(random_gt(
            rng, args.batch, 4, CANVAS[0], CANVAS[1], 80, 64)).to(device),
    }
    for step in range(2):  # warm-up
        train_step(batch, step, step_generator(SEED, step, device))
    torch.cuda.synchronize()

    start, stop = events()
    start.record()
    for step in range(2, 2 + args.iters):
        train_step(batch, step, step_generator(SEED, step, device))
    stop.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(stop) / args.iters
    print(f"step_ms={step_ms:.2f} images_per_s={1000 * args.batch / step_ms:.2f}"
          f" batch={args.batch} peak_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f}")

    # The step's parts, each bracketed by CUDA events.
    trainable = [p for p in params.values() if p.requires_grad]
    timer = StageTimer(model)
    for name in TRAIN_STAGE_FUNCTIONS[len(STAGE_FUNCTIONS):]:
        setattr(model_module, name,
                timer._wrap(name, getattr(model_module, name)))
    parts = {"forward": [], "loss": [], "backward": [], "optimizer": []}
    images = batch["image"].float()
    with timer.recording():
        for step in range(args.iters):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            marks[0].record()
            model.train()
            preds = model(images, gt_boxes=batch["gt_boxes"],
                          generator=step_generator(SEED, step, device))
            marks[1].record()
            losses = model.loss(preds, return_all=True)
            reg_fn()
            marks[2].record()
            grads = torch.autograd.grad(losses["total_loss"], trainable)
            marks[3].record()
            named = dict(zip([n for n, p in params.items() if p.requires_grad],
                             grads))
            optimizer.step(named, step)
            marks[4].record()
            for i, part in enumerate(parts):
                parts[part].append((marks[i], marks[i + 1]))
    for part, spans in parts.items():
        ms = float(np.mean([a.elapsed_time(b) for a, b in spans]))
        print(f"part  {part:22s} {ms:9.3f} ms {100 * ms / step_ms:5.1f}%")
    for name, ms in sorted(timer.mean_ms().items(), key=lambda kv: -kv[1]):
        print(f"stage {name:22s} {ms:9.3f} ms {100 * ms / step_ms:5.1f}%")

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        wall = time.perf_counter()
        for step in range(3):
            train_step(batch, step, step_generator(SEED, step, device))
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"profiled 3 steps: wall_ms={1000 * wall:.2f} "
          f"device_busy_ms={busy_us / 1000:.2f} "
          f"busy_share={busy_us / 1e6 / wall:.3f}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=30, max_name_column_width=70))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "train_trace.json"))


if __name__ == "__main__":
    main()
