#!/usr/bin/env python3
"""Where the time of the PyTorch port's served forward goes, on one GPU.

    python scripts/profile_torch_serve.py [--batch 8] [--iters 5] [--out DIR]

Builds the serving configuration of ``chip_smoke.py`` (Faster R-CNN
ResNet-101 v1, 80 classes, bf16, 608x800 canvas, random weights from a
seed), uploads one batch, and then:

* times each stage of ``FasterRCNN.forward`` with CUDA events (trunk, RPN
  head, RPN proposals, ROI crop+pool, block4 tail, RCNN head, final
  detections) and the whole forward;
* traces a few forwards with ``torch.profiler`` and prints the device time
  by kernel and the device's busy share of the traced wall time.

``--out`` also writes the Chrome trace there. Needs a CUDA device.
"""

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import CANVAS, SEED, serve_config  # noqa: E402
from luminoth_tpu_torch.models.fasterrcnn import model as model_module  # noqa: E402
from luminoth_tpu_torch.utils.config import get_config  # noqa: E402
from luminoth_tpu_torch.utils.predicting import PredictorNetwork  # noqa: E402
from luminoth_tpu_torch.utils.weights import init_variables  # noqa: E402

STAGE_FUNCTIONS = ("rpn_proposal", "roi_crop_pool_batch", "rcnn_proposal")
STAGE_MODULES = ("base_network", "rpn", "base_network_tail", "rcnn")


class StageTimer:
    """CUDA-event spans around the forward's modules and stage functions."""

    def __init__(self, model):
        self.spans = {}
        self.enabled = False
        for name in STAGE_MODULES:
            module = getattr(model, name)
            module.register_forward_pre_hook(self._pre(name))
            module.register_forward_hook(self._post(name))
        for name in STAGE_FUNCTIONS:
            setattr(model_module, name, self._wrap(name,
                                                   getattr(model_module, name)))

    def _pre(self, name):
        def hook(module, args):
            if self.enabled:
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                self.spans.setdefault(name, []).append([event, None])
        return hook

    def _post(self, name):
        def hook(module, args, output):
            if self.enabled:
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                self.spans[name][-1][1] = event
        return hook

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            if not self.enabled:
                return fn(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
            self.spans.setdefault(name, []).append([start, stop])
            return out
        return wrapped

    @contextlib.contextmanager
    def recording(self):
        self.spans = {}
        self.enabled = True
        try:
            yield
        finally:
            self.enabled = False
            torch.cuda.synchronize()

    def mean_ms(self):
        return {
            name: float(np.mean([a.elapsed_time(b) for a, b in spans]))
            for name, spans in self.spans.items()
        }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: no CUDA device is available")

    device = torch.device("cuda", 0)
    config = get_config(serve_config("resnet_v1_101", 80, "bfloat16", CANVAS))
    network = PredictorNetwork(config, init_variables(config, SEED),
                               device=device)
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(rng.integers(
        0, 256, (args.batch, CANVAS[0], CANVAS[1], 3), dtype=np.uint8
    )).to(device)
    im_shape = torch.tensor([CANVAS] * args.batch, dtype=torch.float32,
                            device=device)
    timer = StageTimer(network._model)
    network.forward(images, im_shape)  # warm-up
    torch.cuda.synchronize()

    with timer.recording():
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            network.forward(images, im_shape)
        stop.record()
    total = start.elapsed_time(stop) / args.iters
    stages = timer.mean_ms()
    print(f"forward_ms={total:.2f} images_per_s={1000 * args.batch / total:.2f}"
          f" batch={args.batch}")
    for name, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"stage {name:22s} {ms:9.3f} ms {100 * ms / total:5.1f}%")

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        wall = time.perf_counter()
        for _ in range(3):
            network.forward(images, im_shape)
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"profiled 3 forwards: wall_ms={1000 * wall:.2f} "
          f"device_busy_ms={busy_us / 1000:.2f} "
          f"busy_share={busy_us / 1e6 / wall:.3f}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=30, max_name_column_width=70))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "serve_trace.json"))


if __name__ == "__main__":
    main()
