#!/usr/bin/env python3
"""Where the time of the port's int8 `fast` layers goes, on one GPU.

    python scripts/profile_torch_int8.py [--iters 3] [--out FILE]

Times, with CUDA events after a warm-up, the Faster R-CNN ResNet-101 block4
tail over 8 images' ROIs (R = 1000, the `fast` budget, and 2000) in bf16
(``resnet.ResNetTail``) against its int8 twin (``Int8ResNetTail``, static
scales calibrated on the first 512 ROIs), and SSD's feature extractor at
batches 32 and 128 in bf16 against its int8 twin, each with its peak
memory. Then it traces one int8 tail forward with ``torch.profiler`` and
prints the device time by kernel. Random weights; needs a CUDA device.
``--out`` writes the numbers as JSON.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from luminoth_tpu_torch.models.base import quantized_tail  # noqa: E402
from luminoth_tpu_torch.models.base.resnet import ResNetTail  # noqa: E402
from luminoth_tpu_torch.models.ssd.feature_extractor import (  # noqa: E402
    SSDFeatureExtractor,
)
from luminoth_tpu_torch.utils.config import Config  # noqa: E402


def cuda_ms(fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def timed(module, x, iters, calibrate):
    """(ms, peak GB above the input) of ``module(x)``; a twin with static
    scales is calibrated on ``calibrate`` first."""
    with torch.inference_mode():
        if quantized_tail.int8_modules(module):
            with quantized_tail.calibrating(module):
                module(calibrate)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: module(x), iters)
        return ms, (torch.cuda.max_memory_allocated() - base) / 1e9


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_int8: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    g = torch.Generator(device=device).manual_seed(0)
    results = {"card": card, "tail": {}, "ssd": {}}

    for rois in (1000, 2000):
        x = torch.relu(torch.randn(8 * rois, 1024, 7, 7, device=device,
                                   generator=g)).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        for name, module in (
                ("bf16", ResNetTail(101, 1024)),
                ("int8", quantized_tail.Int8ResNetTail(
                    101, 1024, static_scales=True))):
            module = module.to(device).eval()
            ms, gb = timed(module, x, args.iters, x[:512])
            results["tail"][f"{name}_r{rois}"] = {"ms": ms, "peak_gb": gb}
            print(f"tail {name} R={rois} (8 images): {ms:.2f} ms, peak "
                  f"{gb:.2f} GB above the input", flush=True)
            if name == "int8" and rois == 1000:
                with torch.inference_mode(), torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]
                ) as prof:
                    module(x)
                    torch.cuda.synchronize()
                print(prof.key_averages().table(
                    sort_by="cuda_time_total", row_limit=15,
                    max_name_column_width=60))
            del module
        del x
        torch.cuda.empty_cache()

    for batch in (32, 128):
        x = (torch.rand(batch, 3, 300, 300, device=device, generator=g)
             * 255 - 120).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        for name, config in (("bf16", {}), ("int8", {
                "int8_trunk": True, "int8_static": True})):
            module = SSDFeatureExtractor(Config(config)).to(device).eval()
            ms, gb = timed(module, x, args.iters, x[:8])
            results["ssd"][f"{name}_b{batch}"] = {"ms": ms, "peak_gb": gb}
            print(f"ssd extractor {name} b{batch}: {ms:.2f} ms, peak "
                  f"{gb:.2f} GB above the input", flush=True)
        del x
        torch.cuda.empty_cache()

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
