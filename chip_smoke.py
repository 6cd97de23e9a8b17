#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, eval and predict/serve
paths on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA GPU and ``nvcc``.
It builds the port's CUDA kernels from ``luminoth_tpu_torch/csrc`` (into
``build/luminoth_tpu_torch/``), holds each kernel against its plain
PyTorch version at the shapes of the serving and training paths, checks
the served model and one train step against the plain versions on a small
input, serves requests through ``Detector`` at full width (Faster R-CNN
ResNet-101 v1, 80 classes, bf16, a 608x800 canvas, random weights from a
seed), then trains that model through ``train.run`` on synthetic
TFRecords (batch 8), resumes from its checkpoint, and holds the ROI
backward kernel against its plain version on a train step's own tensors
and times it there. Then it uses that checkpoint as a user would: ``lumi
eval``'s ``evaluate_once`` over 36 synthetic val images (holding the
uncapped per-class NMS launch against its plain version), eval on the card
against the CPU at a small size, the ``predict`` command against
``Detector.predict``, ``PredictorNetwork``'s single-image latency, and the
web server with its micro-batcher under concurrent requests. Then SSD
(truncated VGG-16, 300x300, 20 classes, random weights from the seed):
its forward and detection paths on the card against the CPU at a small
size, serving at batches 32 and 128 (bf16) with the grouped NMS held
against its plain version on each forward's own tensors, ``train.run`` at
batch 32 (no kernel launched), and ``evaluate_once`` on that checkpoint
(the per-class NMS held the same way). The int8 ``fast`` serving profile:
its int8 layers on the card against the CPU at a small size
(``[int8-parity]``), Faster R-CNN under ``fast`` at full width beside the
``accurate`` forward (``[fast-serve]``, K1 and K2 held on its own
tensors), SSD under ``fast`` at batches 32 and 128 (``[ssd-fast-serve]``)
and a one-image ``predict --profile fast`` request for each model
(``[fast-predict]``). The checkpoint zoo: [train]'s checkpoint through
``checkpoint create``/``export``/``build-index`` into a ``file://`` index
in a fresh ``LUMI_HOME``, then ``Detector(checkpoint=alias)``, which must
equal a ``PredictorNetwork`` on the same checkpoint bit for bit, ``predict
--checkpoint`` and ``server web --checkpoint`` (``[zoo]``). The other
backbones at full width, each first on the card against the CPU at a small
size: ResNet-101 v2, ResNet-101 v1 with ``torchvision_compat`` and VGG-16,
whose 512-channel map K2 takes (``[backbones]``). Then ``checkpoint
convert-backbone`` of seeded torchvision-layout VGG-16 and ResNet-101
weights and 3 ``train.run`` steps from each, K3 held and timed at 512
channels (``[pretrained-train]``).
Every phase prints one line; any failure exits non-zero. The last three
lines are the kernels' JSON record, the card's name and power limit, and
``{"ok": true, ...}``.

Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

SEED = 0
K1_SHAPES = (  # (groups, candidates, IoU threshold, survivors read)
    (8, 12000, 0.7, 2000),  # RPN: batch 8, top 12000, keep 2000
    (640, 512, 0.5, 100),  # per class, capped: 8 images x 80 classes
    (640, 2000, 0.5, 100),  # per class, uncapped (eval semantics)
)
K2_SHAPE = (8, 2000, 38, 50, 1024, 14)  # B, R, H, W, C, S
K2_F32_ATOL = 1e-5
# bf16 maps: the kernel sums in float32 and rounds once, so it is within
# half a bf16 ulp (2^-8 relative) of the float32 plain version, plus the
# float32 summation-order difference (1e-6 relative).
K2_BF16_RTOL, K2_BF16_ATOL = 2.0 ** -8 + 1e-6, 1e-5
# K3 at the train shape: B, R (the RCNN minibatch), H, W, C, S.
K3_SHAPE = (8, 256, 38, 50, 1024, 14)
K3_EXACT_TOL = 1e-6  # (a) on-cell samples: atol and rtol
K3_TOL = 1e-4  # (b) random boxes, outside near-tie windows: atol and rtol
K3_NEAR_TIE = 1e-5  # (b) a window whose top two samples are this close
K3_IDENTITY_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}  # (c)
BOX_ATOL = 1e-2  # px, served model vs the plain versions on a small input
# One train step on the card against the same step on the CPU (f32, R101,
# 2x160x224): losses relative; per tensor, the gradients and the updates
# (-lr * momentum trace) ||d|| <= rtol ||x|| + atol * (global norm of x).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 1e-3, 1e-6
TRAIN_UPDATE_RTOL, TRAIN_UPDATE_ATOL = 1e-3, 1e-6
TRAIN_STEPS, RESUME_STEPS = 6, 2  # full-width train phase, then a resume
TRAIN_IMAGES = 16  # synthetic 480x640 JPEGs, 2-6 boxes each
CANVAS = (608, 800)
SMALL_CANVAS = (160, 224)  # [parity] and [eval-parity]
BATCH = 8
# The least time the card could take (bound_ms): bytes over the memory rate
# or float32 operations over the rate outside the tensor cores, whichever
# is larger, at the published H100 SXM peaks.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
IOU_OPS = 20  # float32 operations of one pair_iou, the division as one
K2_OPS = 39  # per pooled output: 4 samples x (6 mul + 3 add), 3 max
# K3 per pooled output: K2's 39, 9 to count ties and scale the cotangent,
# 12 to route it through one maximal sample's 4 taps.
K3_OPS = 60
EVAL_IMAGES = 36  # [eval]: 4 batches of 8 and a final 4, padded to 8
# [eval-parity]: 5 images at batch 2, card against CPU: AP/AR atol, losses
# relative.
EVAL_PARITY_IMAGES, EVAL_PARITY_BATCH = 5, 2
EVAL_AP_ATOL, EVAL_LOSS_RTOL = 1e-6, 1e-5
PREDICT_IMAGES = 4
PREDICT_BOX_ATOL = 1e-3  # px, the predict command against Detector.predict
SERVE_CALLS = 20  # [serve-latency], as bench.py::bench_serving
WEB_REQUESTS, WEB_ROUNDS = 8, 3  # [web]: rounds of concurrent requests
# SSD (truncated VGG-16, 300x300, 8096 anchors): K1 at its launch shapes,
# (groups, candidates, IoU threshold, survivors read, class-shifted boxes):
# the fused per-image path at serving batches 32 and 128, the per-class
# path at eval batch 8 and at batch 32, 20 classes.
K1_SSD_SHAPES = (
    (32, 1000, 0.45, 100, True),
    (128, 1000, 0.45, 100, True),
    (160, 1000, 0.45, 100, False),
    (640, 1000, 0.45, 100, False),
)
SSD_CLASSES, SSD_SIZE = 20, 300
SSD_SERVE_BATCHES = (32, 128)
SSD_TRAIN_BATCH, SSD_TRAIN_STEPS, SSD_TRAIN_IMAGES = 32, 5, 64
SSD_EVAL_IMAGES, SSD_EVAL_BATCH = 20, 8  # 2 batches of 8, a final 4 padded
# [ssd-parity]: 3 classes, f32, batch 2, card against CPU: the losses
# relative; every anchor's class logits and box offsets, absolute; the
# detection stage on the card's head outputs, boxes in px.
SSD_LOSS_RTOL, SSD_HEAD_ATOL, SSD_BOX_ATOL = 1e-5, 1e-4, 1e-4
SSD_LOGIT_STD = 3.0  # [ssd-serve]: class logits rescaled to this std
# The int8 `fast` serving profile: the share of int8 codes that may flip
# card against CPU at a quant point after a float layer. cuDNN's float32
# convolutions (Winograd for 3x3 among them) differ from the CPU's by up to
# ~1e-5 relative; that moves a range by as much and flips each code within
# that of a rounding boundary (measured: 0.6% at SSD's conv3_1); the int8
# layers after it carry those flips on (4.9% at a later SSD point). Their
# outputs, relative to the largest magnitude, within INT8_MAP_RTOL: a check
# for gross faults (a layout, a padding); the exact cases are bitwise. The
# small `fast` Faster R-CNN card against CPU: calibrated maxima (relative)
# and boxes (px); the int8 tail's ROIs in [int8-parity].
INT8_FLIP_BOUND, INT8_MAP_RTOL = 2e-2, 0.25
# Of the small `fast` Faster R-CNN's top FAST_PARITY_DETECTIONS per image
# at least FAST_PAIRED_SHARE pair within FAST_BOX_ATOL px and
# FAST_PROB_ATOL: codes flipped after cuDNN's float trunk move the int8
# tail's outputs by ~1% (the JAX package against the port on the CPU:
# probabilities 3e-3 apart; card against CPU, 3 of 10 outside 0.1 px and
# 5e-3; at the 300 cap with 80 classes at min_prob 0, near-ties reorder:
# 41 of 300). The tail itself is held bitwise on the card forward's own
# ROI features.
FAST_SCALE_RTOL, FAST_BOX_ATOL, FAST_PROB_ATOL = 1e-2, 1.0, 2e-2
FAST_PARITY_DETECTIONS, FAST_PAIRED_SHARE = 10, 0.8
PROB_ATOL = 1e-4 + 1e-5  # the predictor rounds probabilities to 4 places
SSD_FAST_BOX_ATOL = 1e-3  # px, SSD `fast` detections card against CPU
INT8_PARITY_ROIS = 24
ZOO_ALIAS = "smoke-zoo"  # [zoo]: [train]'s checkpoint as a zoo bundle
# [backbones]: (name, architecture, base_network keys), full width.
BACKBONES = (
    ("resnet_v2_101", "resnet_v2_101", None),
    ("resnet_v1_101_tv", "resnet_v1_101", {"torchvision_compat": True}),
    ("vgg_16", "vgg_16", None),
)
# [pretrained-train]: (name, architecture, base_network keys, a converted
# tensor that does not train: (module under base_network, attribute, .npz
# key, whether it is a conv kernel)), 3 steps each.
PRETRAINED = (
    ("vgg_16_tv", "vgg_16", {"fine_tune_from": "conv3"},
     ("vgg_16.conv1.conv1_1", "weight",
      "params/base_network/vgg_16/conv1/conv1_1/kernel", True)),
    ("resnet_v1_101_tv", "resnet_v1_101", {"torchvision_compat": True},
     ("resnet_v1_101.block3.unit_7.conv2_bn", "running_mean",
      "batch_stats/base_network/resnet_v1_101/block3/unit_7/conv2_bn/"
      "BatchNorm/mean", False)),
)
PRETRAINED_STEPS = 3
HERE = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(HERE, "build", "chip_smoke")


def phase(name, **numbers):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in numbers.items()),
          flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=1):
    """Mean device milliseconds of ``fn()`` over ``iters`` after warm-up."""
    import torch

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


def bound(nbytes, ops):
    """``(bound_ms, bound_by)`` of a kernel moving ``nbytes`` and doing
    ``ops`` float32 operations."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / F32_OPS_PER_S
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


def k1_bound(boxes, valid, alive, keep):
    """K1's bound on this data: read the boxes and valid flags, write the
    mask, and compute the IoUs greedy NMS needs: each survivor before the
    ``keep``-th (every survivor when there are fewer) against the later
    candidates up to that one."""
    import torch

    g, n = valid.shape
    pairs = 0
    for row in alive:
        pos = torch.nonzero(row).flatten()
        if keep and len(pos) >= keep:
            last, pos = int(pos[keep - 1]) + 1, pos[:keep - 1]
        else:
            last = n
        pairs += int((last - 1 - pos).sum())
    return bound(boxes.numel() * 4 + 2 * g * n, IOU_OPS * pairs)


def k2_bound(fm, boxes, s):
    """K2's bound: read the maps and boxes, write the pooled crops."""
    b, h, w, c = fm.shape
    outputs = b * boxes.shape[1] * (s // 2) ** 2 * c
    return bound((fm.numel() + outputs) * fm.element_size()
                 + boxes.numel() * 4, K2_OPS * outputs)


def k3_bound(fm, boxes, grad):
    """K3's bound: read the maps, boxes and cotangents, write the float32
    map gradient."""
    return bound((fm.numel() + grad.numel()) * fm.element_size()
                 + boxes.numel() * 4 + fm.numel() * 4, K3_OPS * grad.numel())


def k2_library_ms(fm, boxes, s):
    """``F.grid_sample(align_corners=True)`` + ``F.max_pool2d`` at K2's
    shapes: the nearest library form, not the same function (TF zeroes a
    whole sample outside the map, grid_sample each tap), timed as a
    yardstick only. The NCHW copy of the map is made before the clock.
    cuDNN's grid sampler is off: it refuses a float32 output of more than
    2^31 elements (the serving shape's), PyTorch's own kernel takes it."""
    import torch
    import torch.nn.functional as F

    b, h, w, c = fm.shape
    r = boxes.shape[1]
    nchw = fm.permute(0, 3, 1, 2).contiguous()
    steps = torch.arange(s, device=fm.device, dtype=torch.float32) / (s - 1)
    y1, x1, y2, x2 = (boxes[..., i:i + 1] for i in range(4))
    gy = 2 * (y1 + steps * (y2 - y1)) - 1  # align_corners: -1 is 0, 1 is H-1
    gx = 2 * (x1 + steps * (x2 - x1)) - 1
    grid = torch.stack(torch.broadcast_tensors(
        gx[:, :, None, :], gy[:, :, :, None]), -1)
    grid = grid.reshape(b, r * s, s, 2).to(fm.dtype)

    def run():
        return F.max_pool2d(F.grid_sample(
            nchw, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True), 2)

    with torch.backends.cudnn.flags(enabled=False):
        return cuda_ms(run, 3, warmup=1)


def first_alive(alive, k):
    """Sorted positions of the first k alive entries per group (-1 pads)."""
    import torch

    n = alive.shape[1]
    pos = torch.arange(n, device=alive.device).expand_as(alive)
    keyed = torch.where(alive, pos, torch.full_like(pos, n))
    first = torch.sort(keyed, dim=1).values[:, :k]
    return torch.where(first < n, first, torch.full_like(first, -1))


def random_sorted_groups(g, n, seed, device):
    """Score-sorted boxes in a 608x800 frame, invalid entries at the tail."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, [CANVAS[1], CANVAS[0]], (g, n, 2))
    wh = rng.uniform(8, 300, (g, n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    valid = np.arange(n)[None, :] < rng.integers(n // 2, n + 1, (g, 1))
    return (torch.from_numpy(boxes).to(device),
            torch.from_numpy(valid).to(device))


def check_k1(device):
    import torch
    from luminoth_tpu_torch.ops import nms

    worst, times = 0, {}
    for g, n, thr, keep in K1_SHAPES:
        boxes, valid = random_sorted_groups(g, n, SEED + n, device)
        got = first_alive(nms.nms_alive_cuda(boxes, valid, thr, keep), keep)
        plain = nms.nms_alive_reference(boxes, valid, thr)
        bound_ms, bound_by = k1_bound(boxes, valid, plain, keep)
        want = first_alive(plain, keep)
        worst = max(worst, int((got - want).abs().max()))
        mismatch = int((got != want).sum())
        if mismatch:
            raise AssertionError(
                f"K1 nms_alive disagrees with its plain version at "
                f"(G={g}, N={n}, thr={thr}, keep={keep}): {mismatch} "
                f"selected positions differ"
            )
        ms = cuda_ms(lambda: nms.nms_alive_cuda(boxes, valid, thr, keep), 20,
                     warmup=3)
        plain_ms = cuda_ms(lambda: nms.nms_alive_reference(boxes, valid, thr),
                           3)
        times[(g, n)] = (ms, plain_ms, bound_ms, bound_by)
        phase("k1", groups=g, candidates=n, threshold=thr, keep=keep,
              equal=True, survivors=int(got.ge(0).sum()),
              kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
              bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)
    return worst, times


def k2_inputs(device):
    import numpy as np
    import torch

    b, r, h, w, c, _ = K2_SHAPE
    rng = np.random.default_rng(SEED)
    # N(0, 1), not relu'd: exact zero ties would hide routing in (b).
    fm = torch.from_numpy(
        rng.standard_normal((b, h, w, c)).astype(np.float32)).to(device)
    xy = rng.uniform(-20, [CANVAS[1], CANVAS[0]], (b, r, 2))
    wh = rng.uniform(4, 400, (b, r, 2))
    rois = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    rois[:, 0] = [0, 0, CANVAS[1], CANVAS[0]]  # samples on dim - 1
    x1, y1, x2, y2 = np.split(rois, 4, axis=-1)
    boxes = np.concatenate(
        [y1 / CANVAS[0], x1 / CANVAS[1], y2 / CANVAS[0], x2 / CANVAS[1]], -1
    ).astype(np.float32)
    return fm, torch.from_numpy(boxes).to(device)


def check_k2(device):
    import torch
    from luminoth_tpu_torch.ops import roi_align

    s = K2_SHAPE[-1]
    fm, boxes = k2_inputs(device)
    got = roi_align.roi_crop_pool_cuda(fm, boxes, s)
    want = roi_align.roi_crop_pool_reference(fm, boxes, s)
    err_f32 = float((got - want).abs().max())
    if not err_f32 <= K2_F32_ATOL:
        raise AssertionError(f"K2 float32 max abs err {err_f32}")
    del got, want

    fm16 = fm.to(torch.bfloat16)
    got = roi_align.roi_crop_pool_cuda(fm16, boxes, s).float()
    want = roi_align.roi_crop_pool_reference(fm16.float(), boxes, s)
    err_bf16 = float((got - want).abs().max())
    bound = K2_BF16_RTOL * want.abs() + K2_BF16_ATOL
    if not bool(((got - want).abs() <= bound).all()):
        raise AssertionError(f"K2 bf16 outside its bound: max err {err_bf16}")
    del got, want

    ms = cuda_ms(lambda: roi_align.roi_crop_pool_cuda(fm16, boxes, s), 10,
                 warmup=2)
    plain_ms = cuda_ms(
        lambda: roi_align.roi_crop_pool_reference(fm16, boxes, s), 2
    )
    ms32 = cuda_ms(lambda: roi_align.roi_crop_pool_cuda(fm, boxes, s), 10,
                   warmup=2)
    plain_ms32 = cuda_ms(
        lambda: roi_align.roi_crop_pool_reference(fm, boxes, s), 2
    )
    bound_ms, bound_by = k2_bound(fm16, boxes, s)
    bound_ms32, _ = k2_bound(fm, boxes, s)
    library_ms = k2_library_ms(fm16, boxes, s)
    phase("k2", shape="x".join(map(str, K2_SHAPE)),
          f32_max_abs_err=err_f32, bf16_max_abs_err=err_bf16,
          bf16_kernel_ms=f"{ms:.4f}", bf16_plain_ms=f"{plain_ms:.4f}",
          bf16_bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
          bf16_library_ms=f"{library_ms:.4f}",
          library="grid_sample+max_pool2d(nearest_form)",
          f32_kernel_ms=f"{ms32:.4f}", f32_plain_ms=f"{plain_ms32:.4f}",
          f32_bound_ms=f"{bound_ms32:.4f}")
    return err_bf16, {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library_ms}


def on_cell_boxes(dim, s):
    """(start, cells between samples) pairs of boxes along a map axis of
    ``dim`` whose S sample coordinates come out integral in float32, as the
    kernel and the plain version compute them."""
    import numpy as np

    f32 = np.float32
    d = f32(dim - 1)
    steps = f32(np.arange(s)) / f32(s - 1)
    pairs = []
    for k in (1, 2):
        for a in range(dim - (s - 1) * k):
            lo, hi = f32(a / (dim - 1)), f32((a + (s - 1) * k) / (dim - 1))
            coords = lo * d + steps * (hi - lo) * d
            if (coords == np.round(coords)).all():
                pairs.append((a, k))
    return np.asarray(pairs)


def k3_on_cell_inputs(device):
    """Check (a)'s inputs: every sample lands exactly on a map cell (tap
    weights 0 or 1), map values distinct within every window, integer
    cotangents: every sum is exact in float32, in any order."""
    import numpy as np
    import torch

    b, r, h, w, c, s = K3_SHAPE
    rng = np.random.default_rng(SEED + 3)
    ys, xs = on_cell_boxes(h, s), on_cell_boxes(w, s)
    (y0, ky), (x0, kx) = (
        np.moveaxis(pairs[rng.integers(0, len(pairs), (b, r))], -1, 0)
        for pairs in (ys, xs)
    )
    boxes = np.stack([y0 / (h - 1), x0 / (w - 1),
                      (y0 + (s - 1) * ky) / (h - 1),
                      (x0 + (s - 1) * kx) / (w - 1)], -1).astype(np.float32)
    # Integers in [1, 251], exact in bf16; within a window (rows ky apart,
    # columns kx apart, ky and kx in {1, 2}) no two are equal.
    yy, xx, cc = np.meshgrid(np.arange(h), np.arange(w), np.arange(c),
                             indexing="ij")
    fm = (((yy * w + xx) * 7 + cc) % 251 + 1).astype(np.float32)
    fm = np.broadcast_to(fm, (b, h, w, c))
    g = rng.integers(-3, 4, (b, r, s // 2, s // 2, c)).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (fm, boxes, g))


def near_tie_taps(fm, boxes, s, gap=K3_NEAR_TIE):
    """Map positions fed by a near-tie contender, and the number of near-tie
    windows.

    A window's contenders are its samples (plain, float32) within ``gap``
    of its maximum, relative to the maximum's magnitude where that exceeds
    1 (float32 rounding is relative): the samples either version may route
    to. A window is a near tie when it has two contenders, unless all of
    them are exact zeros (no nonzero map value under a nonzero tap weight:
    outside the map, or a relu'd zero region). Those are exactly 0 in both
    versions, an exact tie split alike, so they are held, not excluded."""
    import torch
    from luminoth_tpu_torch.ops.roi_align import interp_weights

    b, h, w, c = fm.shape
    p = s // 2
    touched = torch.zeros(fm.shape, dtype=torch.bool, device=fm.device)
    windows = 0
    for i in range(b):
        wy, wx = interp_weights(boxes[i], h, w, s)
        r = wy.shape[0]

        def windows_of(values):
            crop = torch.einsum("rtw,rswc->rstc", wx,
                                torch.einsum("rsh,hwc->rswc", wy, values))
            return crop.reshape(r, p, 2, p, 2, c)

        win = windows_of(fm[i].float())
        exact_zero = windows_of(fm[i].float().abs()) == 0
        top = win.amax(dim=(2, 4), keepdim=True)
        contender = win >= top - gap * top.abs().clamp(min=1.0)
        near = (contender.sum(dim=(2, 4), keepdim=True) >= 2) & (
            contender & ~exact_zero).any(dim=(2, 4), keepdim=True)
        windows += int(near.sum())
        contender = (near & contender).reshape(r, s, s, c).float()
        taps = torch.einsum(
            "rsh,rswc->hwc", (wy != 0).float(),
            torch.einsum("rtw,rstc->rswc", (wx != 0).float(), contender))
        touched[i] = taps > 0
    return touched, windows


def hold_k3(fm, boxes, grad, s, exact=False):
    """K3 against its plain version (check (a) when ``exact``, else (b))
    and against K2 through Euler's identity (check (c)).

    Returns a dict of the numbers measured.
    """
    import torch
    from luminoth_tpu_torch.ops import roi_align

    dtype = str(fm.dtype).split(".")[-1]
    got = roi_align.roi_crop_pool_backward_cuda(fm, boxes, grad, s)
    want = roi_align.roi_crop_pool_backward_reference(fm, boxes, grad, s)
    diff = (got - want).abs()
    tol = K3_EXACT_TOL if exact else K3_TOL
    bad = diff > tol + tol * want.abs()
    out = {}
    if exact:
        near, windows = torch.zeros_like(bad), 0
    else:
        near, windows = near_tie_taps(fm, boxes, s)
        out["near_tie_windows"] = windows
        out["excluded_share"] = f"{float(near.float().mean()):.2e}"
    out["max_abs_err"] = float(diff.masked_fill(near, 0).max())
    if bool((bad & ~near).any()):
        raise AssertionError(
            f"K3 {dtype} disagrees with its plain version at "
            f"{int((bad & ~near).sum())} map positions (max err "
            f"{out['max_abs_err']}, tolerance {tol}, near-tie windows "
            f"{windows})")
    # (c) sum(d_fm * fm) == sum(g * K2(fm)): crop + max-pool is positively
    # homogeneous of degree 1 and the tie split keeps the identity.
    pooled = roi_align.roi_crop_pool_cuda(fm, boxes, s).double()
    g64 = grad.double()
    lhs = float((got.double() * fm.double()).sum())
    rhs = float((g64 * pooled).sum())
    rel = abs(lhs - rhs) / float((g64 * pooled).abs().sum())
    out["identity_rel_err"] = f"{rel:.2e}"
    if not rel <= K3_IDENTITY_RTOL[dtype]:
        raise AssertionError(
            f"K3 {dtype} breaks sum(d_fm*fm) = sum(g*K2(fm)): relative "
            f"error {rel} > {K3_IDENTITY_RTOL[dtype]}")
    return out


def k3_random_inputs(device):
    """Check (b)'s float32 map, boxes and cotangents at K3_SHAPE: N(0, 1)
    values, boxes uniform over the canvas."""
    import numpy as np
    import torch

    b, r, h, w, c, s = K3_SHAPE
    rng = np.random.default_rng(SEED + 4)
    g = torch.from_numpy(
        rng.standard_normal((b, r, s // 2, s // 2, c)).astype(np.float32)
    ).to(device)
    # N(0, 1), not relu'd: exact zero ties would hide routing in (b).
    fm = torch.from_numpy(
        rng.standard_normal((b, h, w, c)).astype(np.float32)).to(device)
    xy = rng.uniform(-20, [CANVAS[1], CANVAS[0]], (b, r, 2))
    wh = rng.uniform(4, 400, (b, r, 2))
    rois = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    x1, y1, x2, y2 = np.split(rois, 4, axis=-1)
    boxes = torch.from_numpy(np.concatenate(
        [y1 / CANVAS[0], x1 / CANVAS[1], y2 / CANVAS[0], x2 / CANVAS[1]], -1
    ).astype(np.float32)).to(device)
    return fm, boxes, g


def check_k3(device):
    import torch
    from luminoth_tpu_torch.ops import roi_align

    s = K3_SHAPE[-1]
    fm_cells, boxes_cells, g_cells = k3_on_cell_inputs(device)
    fm, boxes, g = k3_random_inputs(device)

    worst, times = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        g_d = g.to(dtype)
        a = hold_k3(fm_cells.to(dtype), boxes_cells, g_cells.to(dtype), s,
                    exact=True)
        fm_d = fm.to(dtype)
        bc = hold_k3(fm_d, boxes, g_d, s)
        worst = max(worst, bc["max_abs_err"])
        ms = cuda_ms(lambda: roi_align.roi_crop_pool_backward_cuda(
            fm_d, boxes, g_d, s), 10, warmup=2)
        plain_ms = cuda_ms(lambda: roi_align.roi_crop_pool_backward_reference(
            fm_d, boxes, g_d, s), 2)
        k2_ms = cuda_ms(lambda: roi_align.roi_crop_pool_cuda(fm_d, boxes, s),
                        10, warmup=2)
        bound_ms, bound_by = k3_bound(fm_d, boxes, g_d)
        times[name] = (ms, plain_ms, bound_ms, bound_by)
        phase("k3", shape="x".join(map(str, K3_SHAPE)), dtype=name,
              a_max_abs_err=a["max_abs_err"],
              a_identity_rel_err=a["identity_rel_err"],
              b_max_abs_err=bc["max_abs_err"],
              b_near_tie_windows=bc["near_tie_windows"],
              b_excluded_share=bc["excluded_share"],
              c_identity_rel_err=bc["identity_rel_err"],
              kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
              bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
              k2_forward_ms=f"{k2_ms:.4f}")
    return worst, times


def serve_config(architecture, classes, dtype, canvas, budgets=None,
                 base_network=None):
    """The config a user would write, as YAML under ``build/``;
    ``base_network`` adds keys to its section (``torchvision_compat``)."""
    import yaml

    model = {
        "type": "fasterrcnn",
        "compute_dtype": dtype,
        "network": {"num_classes": classes},
        "base_network": {"architecture": architecture,
                         **(base_network or {})},
        # Random weights give no class 0.5: keep every class in the NMS.
        "rcnn": {"proposals": {"min_prob_threshold": 0.0}},
    }
    for stage, values in (budgets or {}).items():
        model.setdefault(stage, {}).setdefault("proposals", {}).update(values)
    config = {
        "model": model,
        "dataset": {"image_preprocessing": {
            "canvas_height": canvas[0], "canvas_width": canvas[1],
        }},
    }
    os.makedirs(BUILD, exist_ok=True)
    extra = "".join(f"_{k}" for k in sorted(base_network or {}))
    path = os.path.join(BUILD,
                        f"{architecture}{extra}_{dtype}_{canvas[0]}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def small_parity_model(architecture="resnet_v1_101", base_network=None):
    """[parity]'s small f32 config (R101 by default, 80 classes, 160x224,
    small RPN budgets), its random weights with rescaled classifiers, two
    images, and ``forward(device)`` of the model on them."""
    import numpy as np
    import torch
    from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN
    from luminoth_tpu_torch.utils.config import get_config
    from luminoth_tpu_torch.utils.weights import (
        init_variables,
        load_flax_variables,
    )

    config = get_config(serve_config(
        architecture, 80, "float32", SMALL_CANVAS,
        budgets={"rpn": {"pre_nms_top_n": 400, "post_nms_top_n": 50}},
        base_network=base_network,
    ))
    variables = init_variables(config, SEED)
    images = torch.from_numpy(
        (np.random.default_rng(SEED).random((2,) + SMALL_CANVAS + (3,))
         * 255).astype(np.float32)
    )

    def forward(device_):
        model = load_flax_variables(FasterRCNN(config), variables)
        model = model.to(device_).eval()
        with torch.inference_mode():
            return model(images.to(device_))

    # Without trained batch-norm statistics the logits saturate; rescale
    # the (linear, bias-free) classifier kernels to a std of 3 so the
    # comparison is of real decisions, not of ties.
    params = variables["params"]
    rpn = forward("cpu")["rpn_prediction"]
    params["rpn"]["cls_conv"]["kernel"] *= 3.0 / float(
        rpn["rpn_cls_score"].std())
    rcnn = forward("cpu")["classification_prediction"]["rcnn"]
    params["rcnn"]["fc_classifier"]["kernel"] *= 3.0 / float(
        rcnn["cls_score"].std())
    params["rcnn"]["fc_bbox"]["kernel"] *= 0.5 / float(
        rcnn["bbox_offsets"].std())
    return config, variables, forward


def check_small_parity(device, architecture="resnet_v1_101",
                       base_network=None, name="parity"):
    """The served path (kernels) against the plain versions, f32, small."""
    import torch

    _, _, forward = small_parity_model(architecture, base_network)
    want = forward("cpu")["classification_prediction"]
    got = forward(device)["classification_prediction"]
    valid = want["valid"]
    same = (
        torch.equal(got["valid"].cpu(), valid)
        and torch.equal(got["labels"].cpu()[valid], want["labels"][valid])
    )
    box_err = float((got["objects"].cpu() - want["objects"])[valid].abs()
                    .max())
    if not same or not box_err <= BOX_ATOL:
        raise AssertionError(
            f"[{name}] {architecture} {base_network or ''}: served path "
            f"disagrees with the plain versions: valid/labels equal={same}, "
            f"box max err {box_err} px"
        )
    phase(name, model=architecture, **(base_network or {}),
          dtype="float32", images="2x160x224", detections=int(valid.sum()),
          labels_equal=True, box_max_err_px=box_err)


def serve(device, card):
    import numpy as np
    import torch
    from luminoth_tpu_torch import Detector
    from luminoth_tpu_torch.ops import nms, roi_align
    from luminoth_tpu_torch.utils.config import get_config
    from luminoth_tpu_torch.utils.weights import init_variables

    path = serve_config("resnet_v1_101", 80, "bfloat16", CANVAS)
    t0 = time.perf_counter()
    variables = init_variables(get_config(path), SEED)
    detector = Detector(config=path, variables=variables, device=device,
                        prob=0.0)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    requests = [
        [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
         for _ in range(BATCH)]
        for _ in range(4)  # one warm-up batch, then three
    ]
    single = rng.integers(0, 256, (600, 800, 3), dtype=np.uint8)

    nms.nms_alive_cuda.launches = 0
    roi_align.roi_crop_pool_cuda.launches = 0
    latencies = []
    results = []
    for batch in requests:
        t = time.perf_counter()
        results.append(detector.predict(batch))
        latencies.append(time.perf_counter() - t)
    results.append([detector.predict(single)])
    launches = {"k1": nms.nms_alive_cuda.launches,
                "k2": roi_align.roi_crop_pool_cuda.launches}
    forwards = len(requests) + 1
    if launches != {"k1": 2 * forwards, "k2": forwards}:
        raise AssertionError(
            f"kernels not on the served path: {launches} over {forwards} "
            f"forwards (want K1 2 and K2 1 per forward)"
        )

    detections = 0
    for batch_result in results:
        for objects in batch_result:
            if not 0 < len(objects) <= 300:
                raise AssertionError(f"{len(objects)} detections for an image")
            probs = [o["prob"] for o in objects]
            if probs != sorted(probs, reverse=True):
                raise AssertionError("detections not sorted by probability")
            for o in objects:
                box = np.asarray(o["bbox"], np.float64)
                if not (box.shape == (4,) and np.isfinite(box).all()
                        and 0 <= o["label"] < 80 and 0.0 <= o["prob"] <= 1.0):
                    raise AssertionError(f"malformed detection {o}")
            detections += len(objects)

    # Device time of the forward alone, on an uploaded batch.
    network = detector._network
    images = torch.from_numpy(
        np.stack([rng.integers(0, 256, (CANVAS[0], CANVAS[1], 3),
                               dtype=np.uint8) for _ in range(BATCH)])
    ).to(device)
    im_shape = torch.tensor([CANVAS] * BATCH, dtype=torch.float32,
                            device=device)
    torch.cuda.reset_peak_memory_stats()
    forward_ms = cuda_ms(lambda: network.forward(images, im_shape), 5,
                         warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady = latencies[1:]
    phase("serve", model="resnet_v1_101", classes=80, dtype="bfloat16",
          canvas=f"{CANVAS[0]}x{CANVAS[1]}", batch=BATCH,
          forwards=forwards, k1_launches=launches["k1"],
          k2_launches=launches["k2"], detections=detections,
          setup_s=f"{setup_s:.1f}",
          request_latency_ms="/".join(f"{1000 * t:.1f}" for t in latencies),
          forward_ms=f"{forward_ms:.2f}",
          images_per_s=f"{1000 * BATCH / forward_ms:.2f}",
          request_images_per_s=f"{BATCH * len(steady) / sum(steady):.2f}",
          peak_gb=f"{peak_gb:.1f}", card=f"'{card}'")
    return launches, detector


def recheck_on_served_tensors(detector, device):
    """K1 and K2 against their plain versions on one served forward's
    own inputs (RPN top-12000 boxes, per-class groups, real feature map)."""
    import numpy as np

    k1s, k2s, survivors = [], [], []
    with capturing_k1(k1s), capturing_k2(k2s):
        rng = np.random.default_rng(SEED + 1)
        detector.predict([rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
                          for _ in range(BATCH)])
    hold_k1(k1s, "k1-served", survivors=survivors, timed=False)
    for (boxes, valid, thr, keep), count in zip(k1s, survivors):
        phase("k1-served", groups=boxes.shape[0], candidates=boxes.shape[1],
              threshold=thr, keep=keep, equal=True, survivors=count)
    errors = []
    hold_k2(k2s, "k2-served", errors=errors, timed=False)
    for (fm, boxes, s), err in zip(k2s, errors):
        phase("k2-served", shape="x".join(map(str, fm.shape)),
              rois=boxes.shape[1], dtype=str(fm.dtype).split(".")[-1],
              max_abs_err=err)


def train_config(path, classes, dtype, canvas, overrides):
    """A training config a user would write, as YAML under ``build/``."""
    import yaml

    model = {
        "type": "fasterrcnn",
        "compute_dtype": dtype,
        "network": {"num_classes": classes},
        "base_network": {"architecture": "resnet_v1_101"},
    }
    config = {
        "train": {
            "batch_size": BATCH, "seed": SEED, "clip_by_norm": True,
            "learning_rate": {"learning_rate": 1e-4},
            "optimizer": {"type": "momentum", "momentum": 0.9},
            "log_every_steps": 1,
        },
        "dataset": {"image_preprocessing": {
            "canvas_height": canvas[0], "canvas_width": canvas[1],
        }},
        "model": model,
    }
    for section, values in overrides.items():
        config[section].update(values)
    os.makedirs(BUILD, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def random_gt(rng, batch, count, height, width, classes, max_gt):
    """(batch, max_gt, 5) padded ground truth with ``count`` boxes each."""
    import numpy as np

    gt = np.zeros((batch, max_gt, 5), np.float32)
    gt[..., 4] = -1
    for b in range(batch):
        n = count if isinstance(count, int) else int(count[b])
        x1 = rng.uniform(0, width * 0.7, n)
        y1 = rng.uniform(0, height * 0.7, n)
        gt[b, :n] = np.stack([
            x1, y1, x1 + rng.uniform(width * 0.1, width * 0.3, n),
            y1 + rng.uniform(height * 0.1, height * 0.3, n),
            rng.integers(0, classes, n),
        ], -1)
    return gt


def train_parity_inputs():
    """Config, variables, batch and priorities of [train-parity]."""
    import numpy as np
    import torch
    from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN
    from luminoth_tpu_torch.utils.config import get_config
    from luminoth_tpu_torch.utils.weights import (
        init_variables,
        load_flax_variables,
    )

    config = get_config(train_config(
        os.path.join(BUILD, "train_parity.yml"), 80, "float32", (160, 224),
        {"model": {"rpn": {"proposals": {"pre_nms_top_n": 400,
                                         "post_nms_top_n": 50}},
                   "rcnn": {"target": {"minibatch_size": 32}}}},
    ))
    variables = init_variables(config, SEED)
    rng = np.random.default_rng(SEED + 5)
    images = torch.from_numpy(
        (rng.random((2, 160, 224, 3)) * 255).astype(np.float32))
    gt = torch.from_numpy(random_gt(rng, 2, 4, 160, 224, 80, 8))
    # Rescale the classifiers as in check_small_parity (unsaturated logits).
    model = load_flax_variables(FasterRCNN(config), variables).eval()
    params = variables["params"]
    with torch.inference_mode():
        rpn = model(images)["rpn_prediction"]
        params["rpn"]["cls_conv"]["kernel"] *= 3.0 / float(
            rpn["rpn_cls_score"].std())
        model = load_flax_variables(FasterRCNN(config), variables).eval()
        rcnn = model(images)["classification_prediction"]["rcnn"]
    params["rcnn"]["fc_classifier"]["kernel"] *= 3.0 / float(
        rcnn["cls_score"].std())
    params["rcnn"]["fc_bbox"]["kernel"] *= 0.5 / float(
        rcnn["bbox_offsets"].std())
    anchors = rpn["rpn_cls_score"].shape[1]
    priorities = {
        "rpn": tuple(torch.from_numpy(rng.random((2, anchors),
                                                 dtype=np.float32))
                     for _ in range(2)),
        "rcnn": tuple(torch.from_numpy(rng.random((2, 50), dtype=np.float32))
                      for _ in range(2)),
    }
    return config, variables, images, gt, priorities


def train_parity_step(device, inputs, inspect=None, proposals=None):
    """One train step on ``device``; returns (metrics, targets, grads,
    updates, RPN proposals, decay shares), all on the CPU.

    ``updates`` are the trainable parameters' updates, -lr * trace: the
    first momentum step's trace is clip(g) + c p. They are read before
    they meet the parameters' float32 rounding (at lr 1e-4 most elements
    move by less than one ulp of the parameter); the parameters must then
    hold exactly before + update, and no other state tensor may move.
    ``decay shares`` are the decay's part of each update, -lr c p.

    ``inspect(model)`` may register hooks first. With ``proposals`` (the
    RPN proposal dict of another step), the step computes its own and then
    goes on with those.
    """
    import torch
    import luminoth_tpu_torch.models.fasterrcnn.model as model_module
    from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN
    from luminoth_tpu_torch.train import make_train_step
    from luminoth_tpu_torch.utils.training import (
        build_trainable_mask,
        build_weight_decay_coefficients,
        get_optimizer,
        l2_regularization_loss,
    )
    from luminoth_tpu_torch.utils.weights import load_flax_variables

    config, variables, images, gt, priorities = inputs
    model = load_flax_variables(FasterRCNN(config), variables).to(device)
    mask = build_trainable_mask(model, config.model)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    named = dict(model.named_parameters())
    decay = build_weight_decay_coefficients(model, config.model)
    optimizer, _ = get_optimizer(config.train, named, mask, decay)
    seen = {}
    model.register_forward_hook(
        lambda module, args, output: seen.update(preds=output))
    if inspect is not None:
        inspect(model)
    update = optimizer.step

    def capture(grads, step):
        seen["grads"] = {k: v.detach().cpu() for k, v in grads.items()}
        return update(grads, step)

    optimizer.step = capture
    train_step = make_train_step(
        model, optimizer,
        reg_fn=lambda: l2_regularization_loss(named, decay).to(device))
    rpn_proposal = model_module.rpn_proposal

    def proposal_capture(*args, **kwargs):
        out = rpn_proposal(*args, **kwargs)
        seen["proposals"] = {k: v.cpu() for k, v in out.items()}
        if proposals is None:
            return out
        return {k: v.to(out[k].device) for k, v in proposals.items()}

    batch = {"image": images.to(device), "gt_boxes": gt.to(device)}
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    neg_lr = -optimizer.schedule(0)
    decay_shares = {k: (neg_lr * c * named[k].detach()).cpu()
                    for k, c in optimizer.decay.items()}
    model_module.rpn_proposal = proposal_capture
    try:
        metrics = train_step(batch, 0, None, priorities)
    finally:
        model_module.rpn_proposal = rpn_proposal
    updates = {k: neg_lr * s["trace"] for k, s in optimizer.slots.items()}
    for k, value in model.state_dict().items():
        if not torch.equal(value, before[k] + updates[k] if k in updates
                           else before[k]):
            raise AssertionError(f"{k} after the step on {device} is not "
                                 f"its value before plus its update")
    rpn = seen["preds"]["rpn_prediction"]
    target = seen["preds"]["classification_prediction"]["target"]
    targets = {
        "rpn_cls": rpn["rpn_cls_target"], "rpn_bbox": rpn["rpn_bbox_target"],
        "rcnn_cls": target["cls"], "rcnn_bbox": target["bbox_offsets"],
        "rcnn_selected": target["selected_mask"],
    }
    return (
        {k: float(v) for k, v in metrics.items()},
        {k: v.detach().cpu() for k, v in targets.items()},
        seen["grads"],
        {k: v.cpu() for k, v in updates.items()},
        seen["proposals"],
        decay_shares,
    )


def worst_over_bound(got, want, rtol, atol):
    """max over tensors of ||got - want|| / (rtol ||want|| + atol G), G the
    global norm of ``want``; tensors that are zero in ``want`` count only
    through the atol term."""
    total = math.sqrt(sum(float(v.double().square().sum())
                          for v in want.values()))
    worst = 0.0
    for name, w in want.items():
        err = float((got[name].double() - w.double()).norm())
        bound = rtol * float(w.double().norm()) + atol * total
        worst = max(worst, err / bound)
    return worst


def reordered_proposals(got, want, gap=K3_NEAR_TIE):
    """Rows where two proposal lists differ; raises unless each such row
    holds one of two proposals whose scores lie within ``gap`` (an order
    swap at a near-tie, which float32 noise may flip)."""
    import torch

    if not torch.equal(got["valid"], want["valid"]):
        raise AssertionError("the card and the plain versions keep different "
                             "numbers of RPN proposals")
    rows = (got["proposals"] - want["proposals"]).abs().amax(-1) > BOX_ATOL
    scores = want["scores"]
    near = torch.zeros_like(rows)
    near[:, 1:] |= (scores[:, 1:] - scores[:, :-1]).abs() <= gap
    near[:, :-1] |= (scores[:, :-1] - scores[:, 1:]).abs() <= gap
    if bool((rows & ~near).any()):
        raise AssertionError(
            f"RPN proposals differ away from near-ties at rows "
            f"{rows.nonzero().tolist()}")
    return int(rows.sum())


def check_train_parity(device):
    """One train step with the kernels on the card against the same step
    with the plain versions on the CPU (f32, R101, 2x160x224)."""
    import torch
    from luminoth_tpu_torch.ops import nms, roi_align
    from luminoth_tpu_torch.utils.training import CLIP_NORM

    kernels = (nms.nms_alive_cuda, roi_align.roi_crop_pool_cuda,
               roi_align.roi_crop_pool_backward_cuda)
    inputs = train_parity_inputs()
    before = [k.launches for k in kernels]
    got = train_parity_step(device, inputs)
    launched = [k.launches - b for k, b in zip(kernels, before)]
    if launched != [1, 1, 1]:
        raise AssertionError(f"the train step on the card launched K1, K2 "
                             f"and K3 {launched} times, not once each")
    # The CPU step computes its own proposals (plain K1), which must equal
    # the card's up to order swaps at near-tie scores, then continues with
    # the card's, so that a swap does not change the minibatch.
    want = train_parity_step("cpu", inputs, proposals=got[4])
    swapped = reordered_proposals(got[4], want[4])
    for name in ("rpn_cls", "rcnn_cls", "rcnn_selected"):
        if not torch.equal(got[1][name], want[1][name]):
            raise AssertionError(f"{name} targets differ between the card "
                                 f"and the plain versions")
    bbox_err = max(float((got[1][n] - want[1][n]).abs().max())
                   for n in ("rpn_bbox", "rcnn_bbox"))
    if not bbox_err <= 1e-3:
        raise AssertionError(f"box targets differ by {bbox_err}")
    loss_err = max(abs(got[0][k] - v) / max(abs(v), 1e-12)
                   for k, v in want[0].items() if k.endswith("loss"))
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"losses differ: relative {loss_err}, "
                             f"card {got[0]}, plain {want[0]}")
    norm = want[0]["grad_norm"]
    grad_ratio = worst_over_bound(got[2], want[2], TRAIN_GRAD_RTOL,
                                  TRAIN_GRAD_ATOL)
    if not grad_ratio <= 1.0:
        raise AssertionError(f"gradients differ: worst error/bound "
                             f"{grad_ratio}")
    update_ratio = worst_over_bound(got[3], want[3], TRAIN_UPDATE_RTOL,
                                    TRAIN_UPDATE_ATOL)
    # Controls: the update check must fail on the card's update skipped,
    # made without the weight decay, or made without the clip (this step's
    # gradient norm is far above it: -lr g = -lr clip(g) * norm / CLIP_NORM).
    shares = {k: got[5].get(k, 0.0) for k in got[3]}
    controls = {
        "skipped": {k: torch.zeros_like(v) for k, v in got[3].items()},
        "no_decay": {k: v - shares[k] for k, v in got[3].items()},
        "no_clip": {k: (v - shares[k]) * (norm / CLIP_NORM) + shares[k]
                    for k, v in got[3].items()},
    }
    control_ratio = {name: worst_over_bound(c, want[3], TRAIN_UPDATE_RTOL,
                                            TRAIN_UPDATE_ATOL)
                     for name, c in controls.items()}
    if not update_ratio <= 1.0 < min(control_ratio.values()):
        raise AssertionError(
            f"updates differ: worst error/bound {update_ratio} (controls "
            f"that must exceed 1: {control_ratio})")
    phase("train-parity", model="resnet_v1_101", dtype="float32",
          images="2x160x224", proposals_swapped_at_near_ties=swapped,
          targets_equal=True,
          rcnn_fg=int((want[1]["rcnn_cls"] > 0).sum()),
          box_target_max_err=f"{bbox_err:.2e}",
          loss_max_rel_err=f"{loss_err:.2e}",
          grad_worst_err_over_bound=f"{grad_ratio:.3f}",
          grad_norm=f"{norm:.4f}",
          update_worst_err_over_bound=f"{update_ratio:.3f}",
          tensors_updated=len(want[3]),
          **{f"control_{k}_err_over_bound": f"{v:.1f}"
             for k, v in control_ratio.items()},
          total_loss=f"{want[0]['total_loss']:.5f}")


def full_train_config(run_name):
    """[train]'s configuration on fresh synthetic TFRecords, with an empty
    job directory for ``run_name``; returns (config, job directory)."""
    import shutil

    from luminoth_tpu_torch.utils.config import get_config
    from luminoth_tpu_torch.utils.synthetic import write_synthetic_records

    jobs = os.path.join(BUILD, "jobs")
    shutil.rmtree(os.path.join(jobs, run_name), ignore_errors=True)
    data, _ = write_synthetic_records(os.path.join(BUILD, "data"),
                                      TRAIN_IMAGES, 80, SEED + 6)
    config = get_config(train_config(
        os.path.join(BUILD, f"{run_name}.yml"), 80, "bfloat16", CANVAS,
        {"train": {"job_dir": jobs, "run_name": run_name},
         "dataset": {"dir": data}},
    ))
    return config, jobs


@contextlib.contextmanager
def capturing_k3(captured):
    """Binds K3's wrapper to one that keeps copies of its last launch's
    inputs in ``captured`` (``[(fm, boxes, grad, s)]``); yields it. The
    wrapper counts its launches on the name it is bound to: on this one."""
    from luminoth_tpu_torch.ops import roi_align

    bwd = roi_align.roi_crop_pool_backward_cuda

    def bwd_capture(fm, boxes, grad, s):
        captured[:] = [(fm.clone(), boxes.clone(), grad.clone(), s)]
        return bwd(fm, boxes, grad, s)

    bwd_capture.launches = 0
    roi_align.roi_crop_pool_backward_cuda = bwd_capture
    try:
        yield bwd_capture
    finally:
        roi_align.roi_crop_pool_backward_cuda = bwd


def trained_k3_inputs(device, steps=2):
    """K3's map, boxes and cotangents at the last of ``steps`` train steps
    of [train]'s configuration, from a fresh start."""
    from luminoth_tpu_torch import train as trainer

    config, _ = full_train_config("k3_capture")
    captured = []
    with capturing_k3(captured):
        trainer.run(config, max_steps=steps, device=device)
    return captured[0]


def train(device, card):
    """Full width through ``train.run``: R101, 80 classes, bf16, batch 8,
    608x800; then a second ``run`` resumes from the checkpoint."""
    import torch
    from luminoth_tpu_torch import train as trainer
    from luminoth_tpu_torch.ops import nms, roi_align

    config, jobs = full_train_config("smoke")
    kernels = {"k1": nms.nms_alive_cuda, "k2": roi_align.roi_crop_pool_cuda,
               "k3": roi_align.roi_crop_pool_backward_cuda}
    for kernel in kernels.values():
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.run(config, max_steps=TRAIN_STEPS, device=device)
    wall_s = time.perf_counter() - t0
    first = {k: f.launches for k, f in kernels.items()}
    if first != {k: TRAIN_STEPS for k in kernels} or (
        state.step != TRAIN_STEPS
    ):
        raise AssertionError(
            f"{state.step} steps launched {first}: want K1, K2 and K3 "
            f"once per step")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    history = state.history
    losses = [h["total_loss"] for h in history]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train losses {losses}")
    steady = [h["device_ms"] for h in history[1:]]
    step_ms = sum(steady) / len(steady)
    ckpt = os.path.join(jobs, "smoke", "ckpt",
                        f"ckpt_step_{TRAIN_STEPS}.pt")
    if not os.path.exists(ckpt):
        raise AssertionError(f"no checkpoint at {ckpt}")
    phase("train", model="resnet_v1_101", classes=80, dtype="bfloat16",
          canvas=f"{CANVAS[0]}x{CANVAS[1]}", batch=BATCH, steps=state.step,
          k1_launches=first["k1"], k2_launches=first["k2"],
          k3_launches=first["k3"],
          losses="/".join(f"{v:.4f}" for v in losses),
          grad_norms="/".join(f"{h['grad_norm']:.3f}" for h in history),
          step_device_ms="/".join(f"{h['device_ms']:.1f}" for h in history),
          steady_step_ms=f"{step_ms:.2f}",
          images_per_s=f"{1000 * BATCH / step_ms:.2f}",
          wall_s=f"{wall_s:.1f}", peak_gb=f"{peak_gb:.1f}", card=f"'{card}'")

    # Resume, capturing K3's inputs of the last step for [k3-trained].
    captured = []
    for kernel in kernels.values():
        kernel.launches = 0
    with capturing_k3(captured) as bwd_capture:
        kernels["k3"] = bwd_capture
        resumed = trainer.run(config, max_steps=TRAIN_STEPS + RESUME_STEPS,
                              device=device)
    launches = {k: f.launches for k, f in kernels.items()}
    losses = [h["total_loss"] for h in resumed.history]
    if resumed.step != TRAIN_STEPS + RESUME_STEPS or launches != {
        k: RESUME_STEPS for k in kernels
    } or len(losses) != RESUME_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(
            f"resume ran to step {resumed.step} with launches {launches} "
            f"and losses {losses}")
    phase("train-resume", from_step=TRAIN_STEPS, to_step=resumed.step,
          k1_launches=launches["k1"], k2_launches=launches["k2"],
          k3_launches=launches["k3"],
          losses="/".join(f"{v:.4f}" for v in losses))
    return {k: first[k] + launches[k] for k in kernels}, captured[0]


def recheck_k3_on_trained_tensors(captured):
    """K3 against its plain version (b) and K2 (c) on a train step's own
    map, boxes and cotangents. The cotangents of a loss averaged over the
    minibatch are tiny next to (b)'s atol, so they are scaled by a power of
    two (exact in bf16) to a largest magnitude in [1, 2): d_fm is linear in
    them and the routing does not depend on them."""
    from luminoth_tpu_torch.ops import roi_align

    fm, boxes, grad, s = captured
    scale = unit_scale(grad)
    out = hold_k3(fm, boxes, grad * scale, s)
    ms = cuda_ms(lambda: roi_align.roi_crop_pool_backward_cuda(
        fm, boxes, grad, s), 10, warmup=2)
    bound_ms, bound_by = k3_bound(fm, boxes, grad)
    phase("k3-trained", shape="x".join(map(str, fm.shape)),
          rois=boxes.shape[1], dtype=str(fm.dtype).split(".")[-1],
          map_max=float(fm.abs().max()), cotangent_scale=scale, **out,
          kernel_ms=f"{ms:.4f}", bound_ms=f"{bound_ms:.4f}",
          bound_by=bound_by)
    return out["max_abs_err"]


def checkpoint_config(name, proposals=None):
    """The config a user would write to evaluate or serve [train]'s
    checkpoint (``jobs/smoke``), as YAML under ``build/``: the model of
    ``bench_eval`` and ``bench_serving`` (``bench.py:704-772``,
    ``:338-396``): R101, 80 classes, bf16, 600-800 resize onto the 608x800
    canvas, uint8 transfer; random-ish weights give no class 0.5, so the
    score floor is 0."""
    return train_config(
        os.path.join(BUILD, f"{name}.yml"), 80, "bfloat16", CANVAS, {
            "train": {"job_dir": os.path.join(BUILD, "jobs"),
                      "run_name": "smoke"},
            "dataset": {"dir": os.path.join(BUILD, "data"),
                        "transfer_dtype": "uint8",
                        "image_preprocessing": {
                            "min_size": 600, "max_size": 800,
                            "canvas_height": CANVAS[0],
                            "canvas_width": CANVAS[1]}},
            "model": {"rcnn": {"proposals": {"min_prob_threshold": 0.0,
                                             **(proposals or {})}}},
        })


def path_launches():
    """Set K1's and K2's launch counts to 0; returns a function that reads
    them."""
    from luminoth_tpu_torch.ops import nms, roi_align

    nms.nms_alive_cuda.launches = roi_align.roi_crop_pool_cuda.launches = 0
    return lambda: {"k1": nms.nms_alive_cuda.launches,
                    "k2": roi_align.roi_crop_pool_cuda.launches}


def check_forwards(name, launches, forwards):
    """Each forward launches K1 twice (RPN, per class) and K2 once."""
    if forwards < 1 or launches != {"k1": 2 * forwards, "k2": forwards}:
        raise AssertionError(
            f"[{name}] kernels not on the path: {launches} over {forwards} "
            f"forwards (want K1 2 and K2 1 per forward)")


def eval_phase(device, card):
    """[eval]: ``lumi eval``'s path on [train]'s checkpoint, loaded as the
    command loads it, over 36 synthetic val images (4 batches of 8 and a
    final batch of 4 padded to 8), after a one-batch warm-up. Holds the
    uncapped per-class K1 launch (G=640, N=2000) of the last forward
    against its plain version on its own tensors."""
    from luminoth_tpu_torch import eval as evaluator
    from luminoth_tpu_torch.models import get_model
    from luminoth_tpu_torch.ops import roi_align
    from luminoth_tpu_torch.utils.checkpoint_io import load_model_weights
    from luminoth_tpu_torch.utils.config import get_config
    from luminoth_tpu_torch.utils.predicting import (
        load_checkpoint_variables,
        model_dtype,
    )
    from luminoth_tpu_torch.utils.synthetic import write_synthetic_records

    write_synthetic_records(os.path.join(BUILD, "data"), EVAL_IMAGES, 80,
                            SEED + 7, split="val")
    config = evaluator.apply_eval_config_mutations(
        get_config(checkpoint_config("eval")), "val")
    model = get_model(config.model.type)(config, dtype=model_dtype(config))
    load_model_weights(model.to(device), load_checkpoint_variables(config))
    evaluator.evaluate_once(config, model, max_batches=1)  # warm-up

    captured = []
    with capturing_k1(captured) as k1:
        roi_align.roi_crop_pool_cuda.launches = 0
        metrics = evaluator.evaluate_once(config, model)
    launches = {"k1": k1.launches,
                "k2": roi_align.roi_crop_pool_cuda.launches}
    batches = math.ceil(EVAL_IMAGES / BATCH)
    check_forwards("eval", launches, batches)
    rpn, classes = config.model.rpn.proposals, config.model.network
    want_shapes = [  # RPN: B x top 12000, keep 2000; per class uncapped
        (BATCH, rpn.pre_nms_top_n, rpn.post_nms_top_n),
        (BATCH * classes.num_classes, rpn.post_nms_top_n,
         config.model.rcnn.proposals.class_max_detections),
    ] * batches
    shapes = [(c[0].shape[0], c[0].shape[1], c[3]) for c in captured]
    if shapes != want_shapes:
        raise AssertionError(f"[eval] K1 launched at {shapes}")
    if metrics["images"] != EVAL_IMAGES or not all(
        math.isfinite(v) for v in metrics.values()
    ):
        raise AssertionError(f"[eval] metrics {metrics}")

    # The last forward's per-class launch, held exactly and timed.
    per_class = [c for c in captured if c[0].shape[0] > BATCH][-1:]
    survivors = []
    k1_ms = hold_k1(per_class, "eval", survivors=survivors)[0]
    boxes, valid, thr, keep = per_class[0]
    phase("eval", model="resnet_v1_101", classes=80, dtype="bfloat16",
          canvas=f"{CANVAS[0]}x{CANVAS[1]}", batch=BATCH,
          images=metrics["images"], batches=batches,
          k1_launches=launches["k1"], k2_launches=launches["k2"],
          k1_per_class=f"{boxes.shape[0]}x{boxes.shape[1]}",
          images_per_s=f"{metrics['images_per_second']:.2f}",
          forward_device_ms=f"{metrics['forward_device_ms']:.2f}",
          ap50=f"{metrics['AP@0.5']:.6f}",
          ap=f"{metrics['AP@[0.5:0.95]']:.6f}",
          ar=f"{metrics['AR@[0.5:0.95]']:.6f}",
          losses="/".join(f"{k.split('/')[1]}={v:.4f}"
                          for k, v in sorted(metrics.items())
                          if k.startswith("losses/")),
          card=f"'{card}'")
    phase("k1-eval", groups=boxes.shape[0], candidates=boxes.shape[1],
          threshold=thr, keep=keep, equal=True,
          survivors=survivors[0], kernel_ms=f"{k1_ms:.4f}")
    return launches


def check_eval_parity(device):
    """[eval-parity]: ``evaluate_once`` on the card (kernels) and on the
    CPU (plain versions) with [parity]'s small f32 model and weights, over
    5 synthetic 120x168 val images at batch 2 (the last batch padded)."""
    from luminoth_tpu_torch import eval as evaluator
    from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN
    from luminoth_tpu_torch.utils.synthetic import write_synthetic_records
    from luminoth_tpu_torch.utils.weights import load_flax_variables

    config, variables, _ = small_parity_model()
    data, _ = write_synthetic_records(
        os.path.join(BUILD, "data_small"), EVAL_PARITY_IMAGES, 80, SEED + 8,
        height=120, width=168, split="val")
    config.dataset.dir = data
    config.dataset.image_preprocessing.min_size = SMALL_CANVAS[0]
    config.dataset.image_preprocessing.max_size = SMALL_CANVAS[1]
    config.train.batch_size = EVAL_PARITY_BATCH
    evaluator.apply_eval_config_mutations(config, "val")
    got, want = (
        evaluator.evaluate_once(
            config, load_flax_variables(FasterRCNN(config), variables)
            .to(on))
        for on in (device, "cpu"))
    ap_err = max(abs(got[k] - want[k]) for k in
                 ("AP@0.5", "AP@0.75", "AP@[0.5:0.95]", "AR@[0.5:0.95]"))
    losses = sorted(k for k in want if k.startswith("losses/"))
    loss_err = max(abs(got[k] - want[k]) / abs(want[k]) for k in losses)
    if (got["images"] != EVAL_PARITY_IMAGES
            or want["images"] != EVAL_PARITY_IMAGES
            or not ap_err <= EVAL_AP_ATOL or not loss_err <= EVAL_LOSS_RTOL
            or sorted(k for k in got if k.startswith("losses/")) != losses):
        raise AssertionError(
            f"[eval-parity] card {got} against the CPU's {want}")
    phase("eval-parity", model="resnet_v1_101", dtype="float32",
          images=got["images"], batch=EVAL_PARITY_BATCH,
          ap_ar_max_abs_err=ap_err, loss_max_rel_err=f"{loss_err:.2e}",
          total_loss=f"{want['losses/total_loss']:.5f}")


def predict_phase(device):
    """[predict]: the ``predict`` command in process on 4 JPEGs with
    [train]'s checkpoint, against ``Detector.predict`` on the same
    images."""
    import numpy as np
    from click.testing import CliRunner
    from PIL import Image
    from luminoth_tpu_torch import Detector
    from luminoth_tpu_torch import predict as predictor
    from luminoth_tpu_torch.io import read_image

    path = checkpoint_config("predict", {"total_max_detections": 100})
    rng = np.random.default_rng(SEED + 9)
    folder = os.path.join(BUILD, "predict")
    os.makedirs(folder, exist_ok=True)
    files = []
    for i in range(PREDICT_IMAGES):
        files.append(os.path.join(folder, f"img{i}.jpg"))
        Image.fromarray(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
                        ).save(files[-1], quality=90)
    out = os.path.join(BUILD, "predict.jsonl")
    read = path_launches()
    result = CliRunner().invoke(predictor.predict, [
        *files, "-c", path, "--min-prob", "0", "--max-detections", "100",
        "--batch-size", str(PREDICT_IMAGES), "--device", str(device),
        "-f", out])
    launches = read()
    if result.exit_code != 0:
        raise AssertionError(f"[predict] exit {result.exit_code}: "
                             f"{result.output}") from result.exception
    check_forwards("predict", launches, 1)
    with open(out) as f:
        lines = [json.loads(line) for line in f]
    want = Detector(config=path, device=device, prob=0.0).predict(
        [read_image(p) for p in files])
    box_err = 0.0
    for line, path_, objects in zip(lines, files, want):
        got = line["objects"]
        if line["file"] != path_ or not got or (
            [o["label"] for o in got] != [o["label"] for o in objects]
            or [o["prob"] for o in got] != [o["prob"] for o in objects]
        ):
            raise AssertionError(f"[predict] {path_}: labels or probs differ "
                                 f"from Detector.predict")
        box_err = max(box_err, float(np.abs(
            np.asarray([o["bbox"] for o in got])
            - np.asarray([o["bbox"] for o in objects])).max()))
    if len(lines) != len(files) or not box_err <= PREDICT_BOX_ATOL:
        raise AssertionError(f"[predict] {len(lines)} lines, box max err "
                             f"{box_err}")
    phase("predict", files=len(lines),
          detections=sum(len(line["objects"]) for line in lines),
          k1_launches=launches["k1"], k2_launches=launches["k2"],
          labels_equal=True, probs_equal=True, box_max_err_px=box_err)
    return launches


def percentiles(seconds):
    """(p50, p90) in ms, as ``bench.py::bench_serving`` takes them."""
    ordered = sorted(seconds)
    return (1000 * ordered[len(ordered) // 2],
            1000 * ordered[int(len(ordered) * 0.9)])


def serve_latency(device, card):
    """[serve-latency]: ``PredictorNetwork`` from [train]'s checkpoint on
    one uint8 480x640 image, ``SERVE_CALLS`` calls after a warm-up, as
    ``bench.py::bench_serving`` does."""
    import numpy as np
    from luminoth_tpu_torch.utils.config import get_config
    from luminoth_tpu_torch.utils.predicting import PredictorNetwork

    network = PredictorNetwork(get_config(checkpoint_config("serve")),
                               device=device)
    image = np.random.default_rng(SEED + 10).integers(
        0, 256, (480, 640, 3), dtype=np.uint8)
    network.predict_image(image)  # warm-up
    read = path_launches()
    seconds = []
    for _ in range(SERVE_CALLS):
        t = time.perf_counter()
        objects = network.predict_image(image)
        seconds.append(time.perf_counter() - t)
    launches = read()
    check_forwards("serve-latency", launches, SERVE_CALLS)
    if not 0 < len(objects) <= 300:
        raise AssertionError(f"[serve-latency] {len(objects)} detections")
    p50, p90 = percentiles(seconds)
    phase("serve-latency", calls=SERVE_CALLS, image="480x640",
          transfer="uint8", k1_launches=launches["k1"],
          k2_launches=launches["k2"], p50_ms=f"{p50:.2f}",
          p90_ms=f"{p90:.2f}", card=f"'{card}'")
    return launches


def web_phase(device, card):
    """[web]: ``run_server`` on 127.0.0.1 with batches of up to 8 serving
    [train]'s checkpoint; ``WEB_ROUNDS`` rounds of 8 concurrent multipart
    POSTs. Each answer must equal ``Detector.predict`` on the batch its
    image rode in (batch size picks cuDNN's algorithms), and the batcher
    must have coalesced each round into fewer than 8 forwards."""
    import io
    import threading
    import urllib.request

    import numpy as np
    from PIL import Image
    from luminoth_tpu_torch import Detector
    from luminoth_tpu_torch.tools.server import web
    from luminoth_tpu_torch.utils.config import get_config

    path = checkpoint_config("serve")
    rng = np.random.default_rng(SEED + 11)
    bodies = []
    for _ in range(WEB_REQUESTS):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
                        ).save(buf, "JPEG", quality=90)
        bodies.append(buf.getvalue())
    images = [np.asarray(Image.open(io.BytesIO(b)).convert("RGB"))
              for b in bodies]

    httpd = web.run_server(get_config(path), host="127.0.0.1", port=0,
                           block=False, batch_size=BATCH, device=device)
    try:
        if not httpd.state.ready.wait(600) or httpd.state.network is None:
            raise AssertionError(f"[web] model not loaded: "
                                 f"{httpd.state.error}")
        predictor = httpd.state.network._network
        for n in (1, 2, 4, 8):  # each batch size picks its own algorithms
            predictor.predict_batch(images[:n], pad_to=n)
        groups, batch_seconds = [], []  # each forward's images and time
        predict_batch = predictor.predict_batch

        def recording(batch, pad_to=None):
            groups.append(list(batch))
            t = time.perf_counter()
            out = predict_batch(batch, pad_to=pad_to)
            batch_seconds.append(time.perf_counter() - t)
            return out

        predictor.predict_batch = recording
        url = (f"http://127.0.0.1:{httpd.server_address[1]}"
               f"/api/fasterrcnn/predict/")
        boundary = "smokeboundary"
        answers, seconds, forwards = {}, [], []

        def post(i):
            body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                    f'name="image"; filename="{i}.jpg"\r\n'
                    f"Content-Type: image/jpeg\r\n\r\n").encode()
            body += bodies[i] + f"\r\n--{boundary}--\r\n".encode()
            request = urllib.request.Request(url, data=body, headers={
                "Content-Type": f"multipart/form-data; boundary={boundary}"})
            t = time.perf_counter()
            with urllib.request.urlopen(request, timeout=300) as response:
                answers[i] = json.load(response)["objects"]
            seconds.append(time.perf_counter() - t)

        read = path_launches()
        rounds = []  # (answers by request, its forwards' image groups)
        for _ in range(WEB_ROUNDS):
            before = len(groups)
            threads = [threading.Thread(target=post, args=(i,))
                       for i in range(WEB_REQUESTS)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=300)
            forwards.append(len(groups) - before)
            if len(answers) != WEB_REQUESTS or forwards[-1] >= WEB_REQUESTS:
                raise AssertionError(
                    f"[web] {len(answers)} answers in {forwards[-1]} "
                    f"forwards")
            rounds.append((dict(answers), groups[before:]))
            answers.clear()
        launches = read()
    finally:
        web.stop_server(httpd)
    check_forwards("web", launches, len(groups))
    detector = Detector(config=path, device=device, prob=0.0)
    for got, round_groups in rounds:
        want = {}
        for group in round_groups:
            for image, objects in zip(group, detector.predict(group)):
                want[next(i for i in range(WEB_REQUESTS)
                          if np.array_equal(images[i], image))] = objects
        if got != want or not all(got.values()):
            raise AssertionError("[web] answers differ from Detector.predict")
    p50, p90 = percentiles(seconds)
    phase("web", requests=WEB_ROUNDS * WEB_REQUESTS, rounds=WEB_ROUNDS,
          forwards_per_round="/".join(map(str, forwards)),
          batch_sizes="/".join(str(len(g)) for g in groups),
          predict_batch_ms="/".join(f"{1000 * t:.1f}"
                                    for t in batch_seconds),
          k1_launches=launches["k1"], k2_launches=launches["k2"],
          answers_equal=True, p50_ms=f"{p50:.2f}", p90_ms=f"{p90:.2f}",
          card=f"'{card}'")
    return launches


def ssd_config(name, classes, dtype, train=None, dataset=None):
    """An SSD config a user would write (the base config's model, 300x300),
    as YAML under ``build/``."""
    import yaml

    config = {
        "model": {"type": "ssd", "compute_dtype": dtype,
                  "network": {"num_classes": classes}},
        "train": {"seed": SEED, "log_every_steps": 1, **(train or {})},
        "dataset": dict(dataset or {}),
    }
    os.makedirs(BUILD, exist_ok=True)
    path = os.path.join(BUILD, f"{name}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def check_k1_ssd(device):
    """K1 at SSD's launch shapes against its plain version: the fused
    path's class-shifted boxes (up to 19e4 + 300: widths and areas are
    differences of large numbers) and the per-class groups."""
    import numpy as np
    import torch
    from luminoth_tpu_torch.ops import nms

    times = {}
    for g, n, thr, keep, shifted in K1_SSD_SHAPES:
        rng = np.random.default_rng(SEED + g)
        xy = rng.uniform(0, SSD_SIZE - 8, (g, n, 2))
        wh = rng.uniform(8, SSD_SIZE / 2, (g, n, 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, SSD_SIZE - 1)], -1)
        boxes = boxes.astype(np.float32)
        if shifted:
            boxes += (rng.integers(0, SSD_CLASSES, (g, n, 1)) * 1e4).astype(
                np.float32)
        valid = np.arange(n)[None, :] < rng.integers(n // 2, n + 1, (g, 1))
        boxes = torch.from_numpy(boxes).to(device)
        valid = torch.from_numpy(valid).to(device)
        got = first_alive(nms.nms_alive_cuda(boxes, valid, thr, keep), keep)
        plain = nms.nms_alive_reference(boxes, valid, thr)
        if not torch.equal(got, first_alive(plain, keep)):
            raise AssertionError(
                f"K1 disagrees with its plain version at SSD's (G={g}, "
                f"N={n}, shifted={shifted})")
        bound_ms, bound_by = k1_bound(boxes, valid, plain, keep)
        ms = cuda_ms(lambda: nms.nms_alive_cuda(boxes, valid, thr, keep), 20,
                     warmup=3)
        plain_ms = cuda_ms(lambda: nms.nms_alive_reference(boxes, valid, thr),
                           3)
        times[(g, n)] = (ms, plain_ms, bound_ms, bound_by)
        phase("k1-ssd", groups=g, candidates=n, threshold=thr, keep=keep,
              class_shifted=shifted, equal=True,
              survivors=int(got.ge(0).sum()), kernel_ms=f"{ms:.4f}",
              plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
              bound_by=bound_by)
    return times


@contextlib.contextmanager
def capturing_k1(captured):
    """Binds K1's wrapper to one that keeps copies of each launch's inputs
    in ``captured``; yields it (it counts its launches)."""
    from luminoth_tpu_torch.ops import nms

    kernel = nms.nms_alive_cuda

    def k1_capture(boxes, valid, thr, keep=0):
        captured.append((boxes.clone(), valid.clone(), thr, keep))
        return kernel(boxes, valid, thr, keep)

    k1_capture.launches = 0
    nms.nms_alive_cuda = k1_capture
    try:
        yield k1_capture
    finally:
        nms.nms_alive_cuda = kernel


@contextlib.contextmanager
def counting_k2_k3(counts):
    """Sets K2's and K3's launch counts to 0 for the block and adds what
    they launched in it to ``counts["k2"]`` and ``counts["k3"]``."""
    from luminoth_tpu_torch.ops import roi_align

    kernels = {"k2": roi_align.roi_crop_pool_cuda,
               "k3": roi_align.roi_crop_pool_backward_cuda}
    for kernel in kernels.values():
        kernel.launches = 0
    yield
    for name, kernel in kernels.items():
        counts[name] = counts.get(name, 0) + kernel.launches


def no_k2_k3(name, counts):
    """Raises unless the SSD path ``name`` launched neither K2 nor K3."""
    if counts["k2"] or counts["k3"]:
        raise AssertionError(f"[{name}] launched K2 {counts['k2']} and K3 "
                             f"{counts['k3']} times")


def valid_per_group(captured):
    """'least/mean/most' valid candidates per group over the captured K1
    launches."""
    import torch

    valid = torch.cat([c[1].sum(-1) for c in captured]).float()
    return (f"{int(valid.min())}/{float(valid.mean()):.1f}/"
            f"{int(valid.max())}")


def hold_k1(captured, name, survivors=None, timed=True):
    """Each captured K1 launch against the plain version, exactly; appends
    each launch's survivors to ``survivors``; returns (kernel ms, plain
    ms, bound ms, bound by) of the last one (None when not ``timed``)."""
    import torch
    from luminoth_tpu_torch.ops import nms

    for boxes, valid, thr, keep in captured:
        got = first_alive(nms.nms_alive_cuda(boxes, valid, thr, keep), keep)
        plain = nms.nms_alive_reference(boxes, valid, thr)
        if not torch.equal(got, first_alive(plain, keep)):
            raise AssertionError(f"[{name}] K1 disagrees with its plain "
                                 f"version on {tuple(boxes.shape)}")
        if survivors is not None:
            survivors.append(int(got.ge(0).sum()))
    if not timed:
        return None
    boxes, valid, thr, keep = captured[-1]
    return (cuda_ms(lambda: nms.nms_alive_cuda(boxes, valid, thr, keep), 20,
                    warmup=3),
            cuda_ms(lambda: nms.nms_alive_reference(boxes, valid, thr), 3),
            *k1_bound(boxes, valid, plain, keep))


@contextlib.contextmanager
def capturing_k2(captured):
    """Binds K2's wrapper to one that keeps copies of each launch's inputs
    in ``captured``; yields it (it counts its launches)."""
    from luminoth_tpu_torch.ops import roi_align

    kernel = roi_align.roi_crop_pool_cuda

    def k2_capture(fm, boxes, s):
        captured.append((fm.clone(), boxes.clone(), s))
        return kernel(fm, boxes, s)

    k2_capture.launches = 0
    roi_align.roi_crop_pool_cuda = k2_capture
    try:
        yield k2_capture
    finally:
        roi_align.roi_crop_pool_cuda = kernel


def hold_k2(captured, name, errors=None, timed=True, library=False):
    """Each captured K2 launch against the plain version on its own
    tensors (float32 maps within ``K2_F32_ATOL``, bf16 within K2's bf16
    bound); appends each max abs error to ``errors``; returns a dict of
    the last one's ms, plain ms, bound ms and bound by, and the library
    form's ms with ``library`` (None when not ``timed``)."""
    import torch
    from luminoth_tpu_torch.ops import roi_align

    for fm, boxes, s in captured:
        got = roi_align.roi_crop_pool_cuda(fm, boxes, s).float()
        want = roi_align.roi_crop_pool_reference(fm.float(), boxes, s)
        diff = (got - want).abs()
        err = float(diff.max())
        if fm.dtype == torch.float32:
            within = err <= K2_F32_ATOL
        else:
            within = bool((diff <= K2_BF16_RTOL * want.abs()
                           + K2_BF16_ATOL).all())
        if not within:
            raise AssertionError(f"[{name}] K2 disagrees with its plain "
                                 f"version on {tuple(fm.shape)}: {err}")
        if errors is not None:
            errors.append(err)
    if not timed:
        return None
    fm, boxes, s = captured[-1]
    bound_ms, bound_by = k2_bound(fm, boxes, s)
    return {
        "ms": cuda_ms(lambda: roi_align.roi_crop_pool_cuda(fm, boxes, s),
                      10, warmup=2),
        "plain_ms": cuda_ms(
            lambda: roi_align.roi_crop_pool_reference(fm, boxes, s), 2),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": k2_library_ms(fm, boxes, s) if library else None,
    }


def check_ssd_parity(device):
    """[ssd-parity]: SSD, 3 classes, f32 (TF32 is off), batch 2, the same
    weights (``flax_variables_from_torch``) on the card and on the CPU:
    the losses; then both detection paths on the card (K1) and on the CPU
    (the plain version), fed the card's head outputs."""
    import numpy as np
    import torch
    from luminoth_tpu_torch.models.ssd import SSD
    from luminoth_tpu_torch.models.ssd.proposal import ssd_proposal
    from luminoth_tpu_torch.ops import nms
    from luminoth_tpu_torch.utils.config import get_config
    from luminoth_tpu_torch.utils.weights import (
        flax_variables_from_torch,
        init_variables,
        load_flax_variables,
    )

    config = get_config(ssd_config("ssd_parity", 3, "float32"))
    variables = flax_variables_from_torch(
        load_flax_variables(SSD(config), init_variables(config, SEED)))
    rng = np.random.default_rng(SEED + 11)
    images = torch.from_numpy(
        (rng.random((2, SSD_SIZE, SSD_SIZE, 3)) * 255).astype(np.float32))
    gt = torch.from_numpy(random_gt(rng, 2, [3, 1], SSD_SIZE, SSD_SIZE, 3, 4))
    outs, losses = {}, {}
    for on in ("cpu", device):
        model = load_flax_variables(SSD(config), variables).to(on).eval()
        with torch.inference_mode():
            outs[on] = model(images.to(on), gt_boxes=gt.to(on))
            losses[on] = {k: float(v) for k, v in
                          model.loss(outs[on], return_all=True).items()}
    loss_err = max(abs(losses[device][k] - v) / abs(v)
                   for k, v in losses["cpu"].items())
    head_err = max(float((outs[device][k].cpu() - outs["cpu"][k]).abs().max())
                   for k in ("cls_pred", "loc_pred"))
    if not loss_err <= SSD_LOSS_RTOL:
        raise AssertionError(f"[ssd-parity] losses {losses}")
    if not head_err <= SSD_HEAD_ATOL:
        raise AssertionError(f"[ssd-parity] head outputs differ by {head_err}")

    got = outs[device]
    probs = torch.softmax(got["cls_pred"], -1)
    p_cfg = config.model.proposals
    numbers = {}
    for path, min_prob in (("fused", 0.5), ("per_class", 0.0)):
        args = (3, float(p_cfg.class_nms_threshold),
                int(p_cfg.class_max_detections),
                int(p_cfg.total_max_detections), min_prob,
                tuple(config.model.variances))
        nms.nms_alive_cuda.launches = 0
        card = ssd_proposal(probs, got["loc_pred"], got["anchors"],
                            (SSD_SIZE, SSD_SIZE), *args)
        launches = nms.nms_alive_cuda.launches
        cpu = ssd_proposal(probs.cpu(), got["loc_pred"].cpu(),
                           got["anchors"].cpu(), (SSD_SIZE, SSD_SIZE), *args)
        valid = cpu["valid"]
        same = (launches == 1 and int(valid.sum()) > 0
                and torch.equal(card["valid"].cpu(), valid)
                and all(torch.equal(card[k].cpu()[valid], cpu[k][valid])
                        for k in ("labels", "probs")))
        box_err = float((card["objects"].cpu() - cpu["objects"])[valid]
                        .abs().max())
        if not same or not box_err <= SSD_BOX_ATOL:
            raise AssertionError(
                f"[ssd-parity] {path}: K1 launches {launches}, valid/labels/"
                f"probs equal={same}, box max err {box_err} px")
        numbers[f"{path}_detections"] = int(valid.sum())
        numbers[f"{path}_box_max_err_px"] = box_err
    phase("ssd-parity", model="ssd_vgg16", classes=3, dtype="float32",
          images=f"2x{SSD_SIZE}x{SSD_SIZE}", tf32=False,
          loss_max_rel_err=f"{loss_err:.2e}", head_max_abs_err=head_err,
          **numbers)


def rescaled_ssd_variables(config, device):
    """Random SSD weights from the seed, the class heads rescaled so the
    logits have a std of ``SSD_LOGIT_STD``: at random init no class
    reaches 0.5, and the fused path would get no candidate."""
    import numpy as np
    import torch
    from luminoth_tpu_torch.models.ssd import SSD
    from luminoth_tpu_torch.utils.predicting import model_dtype
    from luminoth_tpu_torch.utils.weights import (
        init_variables,
        load_flax_variables,
    )

    variables = init_variables(config, SEED)
    model = load_flax_variables(SSD(config, dtype=model_dtype(config)),
                                variables).to(device).eval()
    images = torch.from_numpy(np.random.default_rng(SEED + 12).integers(
        0, 256, (8, SSD_SIZE, SSD_SIZE, 3), dtype=np.uint8)).to(device)
    with torch.inference_mode():
        scale = SSD_LOGIT_STD / float(model(images.float())["cls_pred"].std())
    for i in range(len(model.anchors_per_point)):
        variables["params"][f"MultiBox_{i}_classes_conv"]["kernel"] *= scale
    return variables


def check_detections(name, results, classes, cap, floor, labels=None):
    """Per image: at most ``cap`` detections sorted by probability, finite
    boxes, labels in range (or among ``labels``, the class names),
    probabilities in [floor, 1]; returns the count."""
    import numpy as np

    count = 0
    for objects in results:
        probs = [o["prob"] for o in objects]
        if len(objects) > cap or probs != sorted(probs, reverse=True):
            raise AssertionError(f"[{name}] {len(objects)} detections "
                                 f"(cap {cap}), or not sorted by "
                                 f"probability")
        for o in objects:
            box = np.asarray(o["bbox"], np.float64)
            known = (o["label"] in labels if labels is not None
                     else 0 <= o["label"] < classes)
            if not (box.shape == (4,) and np.isfinite(box).all() and known
                    and floor - 1e-4 <= o["prob"] <= 1.0):
                raise AssertionError(f"[{name}] malformed detection {o}")
        count += len(objects)
    return count


def ssd_serve(device, card):
    """[ssd-serve]: ``PredictorNetwork`` from an SSD config (the base
    config's fused detection path: min_prob 0.5, 100 per image), bf16, 20
    classes, uint8 transfer, batches of 32 and 128 375x500 images in one
    forward each, after a warm-up; K1 once per forward at G = B, N = 1000,
    each launch held against the plain version on its own tensors. Then
    ``Detector.predict`` on one image. K2 and K3 must not launch. Returns
    the K1, K2 and K3 launches of the measured forwards and K1's times per
    batch."""
    import numpy as np
    import torch
    from luminoth_tpu_torch import Detector
    from luminoth_tpu_torch.ops import nms
    from luminoth_tpu_torch.utils.config import get_config
    from luminoth_tpu_torch.utils.predicting import PredictorNetwork

    path = ssd_config("ssd_serve", SSD_CLASSES, "bfloat16",
                      dataset={"transfer_dtype": "uint8"})
    config = get_config(path)
    t0 = time.perf_counter()
    variables = rescaled_ssd_variables(config, device)
    network = PredictorNetwork(config, variables=variables, device=device)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 13)
    launches, counts, k1_times = 0, {}, {}
    for batch in SSD_SERVE_BATCHES:
        images = [rng.integers(0, 256, (375, 500, 3), dtype=np.uint8)
                  for _ in range(batch)]
        network.predict_batch(images)  # warm-up
        captured = []
        with capturing_k1(captured) as k1, counting_k2_k3(counts):
            t = time.perf_counter()
            results = network.predict_batch(images)
            request_s = time.perf_counter() - t
        shapes = [tuple(c[0].shape[:2]) + (c[3],) for c in captured]
        if k1.launches != 1 or shapes != [(batch, 1000, 100)]:
            raise AssertionError(f"[ssd-serve] b{batch}: K1 launched "
                                 f"{k1.launches} times at {shapes}")
        launches += k1.launches
        detections = check_detections("ssd-serve", results, SSD_CLASSES,
                                      100, 0.5)
        if detections == 0:
            raise AssertionError(f"[ssd-serve] b{batch}: no detection")
        k1_times[batch] = hold_k1(captured, "ssd-serve")
        uploaded = torch.from_numpy(rng.integers(
            0, 256, (batch, SSD_SIZE, SSD_SIZE, 3), dtype=np.uint8)).to(device)
        im_shape = torch.tensor([[SSD_SIZE, SSD_SIZE]] * batch,
                                dtype=torch.float32, device=device)
        torch.cuda.reset_peak_memory_stats()
        forward_ms = cuda_ms(lambda: network.forward(uploaded, im_shape), 5,
                             warmup=1)
        k1_ms, k1_plain_ms, k1_bound_ms, _ = k1_times[batch]
        phase("ssd-serve", model="ssd_vgg16", classes=SSD_CLASSES,
              dtype="bfloat16", canvas=f"{SSD_SIZE}x{SSD_SIZE}", batch=batch,
              transfer="uint8", k1_launches=k1.launches,
              k1_shape=f"{batch}x1000", k1_equal=True,
              k1_valid_per_group=valid_per_group(captured),
              detections=detections,
              forward_ms=f"{forward_ms:.2f}",
              images_per_s=f"{1000 * batch / forward_ms:.2f}",
              request_ms=f"{1000 * request_s:.1f}",
              request_images_per_s=f"{batch / request_s:.2f}",
              peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.1f}",
              k1_ms=f"{k1_ms:.4f}", k1_plain_ms=f"{k1_plain_ms:.4f}",
              k1_bound_ms=f"{k1_bound_ms:.4f}", setup_s=f"{setup_s:.1f}",
              card=f"'{card}'")
    detector = Detector(config=path, variables=variables, device=device,
                        prob=0.0)
    nms.nms_alive_cuda.launches = 0
    with counting_k2_k3(counts):
        objects = detector.predict(rng.integers(0, 256, (480, 640, 3),
                                                dtype=np.uint8))
    check_detections("ssd-serve", [objects], SSD_CLASSES, 100, 0.5)
    launches += nms.nms_alive_cuda.launches
    if nms.nms_alive_cuda.launches != 1:
        raise AssertionError("[ssd-serve] Detector.predict: K1 launched "
                             f"{nms.nms_alive_cuda.launches} times")
    no_k2_k3("ssd-serve", counts)
    return {"k1": launches, **counts}, k1_times


def ssd_train(device, card):
    """[ssd-train]: ``train.run`` with an SSD config (20 classes, bf16,
    the base config's training defaults and augmentations), batch 32, on
    64 synthetic 300x300 JPEG records, ``SSD_TRAIN_STEPS`` steps: finite
    losses, no kernel launched, a ``.pt`` checkpoint; then 5 further steps
    back to back on one uploaded batch."""
    import shutil

    import numpy as np
    import torch
    from luminoth_tpu_torch import train as trainer
    from luminoth_tpu_torch.ops import nms, roi_align
    from luminoth_tpu_torch.utils.config import get_config
    from luminoth_tpu_torch.utils.synthetic import write_synthetic_records

    jobs = os.path.join(BUILD, "jobs")
    shutil.rmtree(os.path.join(jobs, "ssd"), ignore_errors=True)
    data, _ = write_synthetic_records(
        os.path.join(BUILD, "data_ssd"), SSD_TRAIN_IMAGES, SSD_CLASSES,
        SEED + 14, height=SSD_SIZE, width=SSD_SIZE)
    config = get_config(ssd_config(
        "ssd_train", SSD_CLASSES, "bfloat16",
        train={"batch_size": SSD_TRAIN_BATCH, "job_dir": jobs,
               "run_name": "ssd"},
        dataset={"dir": data}))
    kernels = {"k1": nms.nms_alive_cuda, "k2": roi_align.roi_crop_pool_cuda,
               "k3": roi_align.roi_crop_pool_backward_cuda}
    for kernel in kernels.values():
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.run(config, max_steps=SSD_TRAIN_STEPS, device=device)
    wall_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in kernels.items()}
    losses = [h["total_loss"] for h in state.history]
    ckpt = os.path.join(jobs, "ssd", "ckpt", f"ckpt_step_{SSD_TRAIN_STEPS}.pt")
    if (state.step != SSD_TRAIN_STEPS or any(launches.values())
            or len(losses) != SSD_TRAIN_STEPS
            or not all(map(math.isfinite, losses))
            or not os.path.exists(ckpt)):
        raise AssertionError(
            f"[ssd-train] {state.step} steps, launches {launches}, losses "
            f"{losses}, checkpoint {os.path.exists(ckpt)}")
    steady = [h["device_ms"] for h in state.history[1:]]
    step_ms = sum(steady) / len(steady)
    # Further steps back to back on one uploaded batch, without the loader:
    # the step's device time alone.
    rng = np.random.default_rng(SEED + 16)
    batch = {
        "image": torch.from_numpy(rng.integers(
            0, 256, (SSD_TRAIN_BATCH, SSD_SIZE, SSD_SIZE, 3),
            dtype=np.uint8)).to(device),
        "gt_boxes": torch.from_numpy(random_gt(
            rng, SSD_TRAIN_BATCH, 4, SSD_SIZE, SSD_SIZE, SSD_CLASSES,
            8)).to(device),
    }
    step = trainer.make_train_step(state.model, state.optimizer)
    b2b_ms = cuda_ms(lambda: step(batch, state.step, None), 5, warmup=1)
    phase("ssd-train", model="ssd_vgg16", classes=SSD_CLASSES,
          dtype="bfloat16", canvas=f"{SSD_SIZE}x{SSD_SIZE}",
          batch=SSD_TRAIN_BATCH, steps=state.step,
          k1_launches=launches["k1"], k2_launches=launches["k2"],
          k3_launches=launches["k3"],
          losses="/".join(f"{v:.4f}" for v in losses),
          step_device_ms="/".join(f"{h['device_ms']:.1f}"
                                  for h in state.history),
          steady_step_ms=f"{step_ms:.2f}",
          images_per_s=f"{1000 * SSD_TRAIN_BATCH / step_ms:.2f}",
          back_to_back_step_ms=f"{b2b_ms:.2f}",
          back_to_back_images_per_s=f"{1000 * SSD_TRAIN_BATCH / b2b_ms:.2f}",
          wall_s=f"{wall_s:.1f}",
          peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.1f}",
          card=f"'{card}'")
    return launches


def ssd_eval(device, card):
    """[ssd-eval]: ``evaluate_once`` on [ssd-train]'s checkpoint, loaded as
    ``lumi eval`` loads it, over 20 synthetic val images at batch 8 (the
    last batch 4 real and 4 padded), after a one-batch warm-up. The eval
    mutations (min_prob 0) take the per-class path: K1 once per batch at
    G = 8 x 20 = 160, N = 1000, each launch held exactly; K2 and K3 must
    not launch."""
    from luminoth_tpu_torch import eval as evaluator
    from luminoth_tpu_torch.models import get_model
    from luminoth_tpu_torch.utils.checkpoint_io import load_model_weights
    from luminoth_tpu_torch.utils.config import get_config
    from luminoth_tpu_torch.utils.predicting import (
        load_checkpoint_variables,
        model_dtype,
    )
    from luminoth_tpu_torch.utils.synthetic import write_synthetic_records

    data, _ = write_synthetic_records(
        os.path.join(BUILD, "data_ssd"), SSD_EVAL_IMAGES, SSD_CLASSES,
        SEED + 15, height=SSD_SIZE, width=SSD_SIZE, split="val")
    config = evaluator.apply_eval_config_mutations(get_config(ssd_config(
        "ssd_eval", SSD_CLASSES, "bfloat16",
        train={"batch_size": SSD_EVAL_BATCH,
               "job_dir": os.path.join(BUILD, "jobs"), "run_name": "ssd"},
        dataset={"dir": data, "transfer_dtype": "uint8"})), "val")
    model = get_model(config.model.type)(config, dtype=model_dtype(config))
    load_model_weights(model.to(device), load_checkpoint_variables(config))
    evaluator.evaluate_once(config, model, max_batches=1)  # warm-up
    captured, counts = [], {}
    with capturing_k1(captured) as k1, counting_k2_k3(counts):
        metrics = evaluator.evaluate_once(config, model)
    no_k2_k3("ssd-eval", counts)
    batches = math.ceil(SSD_EVAL_IMAGES / SSD_EVAL_BATCH)
    shapes = [tuple(c[0].shape[:2]) + (c[3],) for c in captured]
    if shapes != [(SSD_EVAL_BATCH * SSD_CLASSES, 1000, 100)] * batches:
        raise AssertionError(f"[ssd-eval] K1 launched at {shapes}")
    if metrics["images"] != SSD_EVAL_IMAGES or not all(
        math.isfinite(v) for v in metrics.values()
    ):
        raise AssertionError(f"[ssd-eval] metrics {metrics}")
    k1_ms, plain_ms, bound_ms, _ = hold_k1(captured, "ssd-eval")
    phase("ssd-eval", model="ssd_vgg16", classes=SSD_CLASSES,
          dtype="bfloat16", canvas=f"{SSD_SIZE}x{SSD_SIZE}",
          batch=SSD_EVAL_BATCH, images=metrics["images"], batches=batches,
          k1_launches=k1.launches, k2_launches=counts["k2"],
          k3_launches=counts["k3"],
          k1_per_class=f"{SSD_EVAL_BATCH * SSD_CLASSES}x1000", k1_equal=True,
          k1_valid_per_group=valid_per_group(captured),
          k1_ms=f"{k1_ms:.4f}", k1_plain_ms=f"{plain_ms:.4f}",
          k1_bound_ms=f"{bound_ms:.4f}",
          images_per_s=f"{metrics['images_per_second']:.2f}",
          forward_device_ms=f"{metrics['forward_device_ms']:.2f}",
          ap50=f"{metrics['AP@0.5']:.6f}",
          ap=f"{metrics['AP@[0.5:0.95]']:.6f}",
          ar=f"{metrics['AR@[0.5:0.95]']:.6f}",
          losses="/".join(f"{k.split('/')[1]}={v:.4f}"
                          for k, v in sorted(metrics.items())
                          if k.startswith("losses/")),
          card=f"'{card}'")
    return {"k1": k1.launches, **counts}


# ------------------------------------------------------------- int8 `fast`


@contextlib.contextmanager
def recording_codes(record):
    """Appends the int8 codes and range (on the CPU) of every activation
    the int8 layers quantize in the block to ``record``."""
    from luminoth_tpu_torch.models.base import quantized_tail

    quantize = quantized_tail.quantize_with_range

    def recorder(x, amax):
        q, r = quantize(x, amax)
        record.append((q.cpu(), r.cpu()))
        return q, r

    quantized_tail.quantize_with_range = recorder
    try:
        yield
    finally:
        quantized_tail.quantize_with_range = quantize


def code_flips(name, cpu, card, bound):
    """Compares two code records point by point. ``bound`` 0: every code
    and range equal. Else at most ``bound`` of the first point's codes may
    differ (the point that reads the float layer); later points inherit
    those flips through the int8 layers and are counted, not bounded.
    Returns (points, codes, flipped codes, most flipped share)."""
    import torch

    if len(cpu) != len(card):
        raise AssertionError(f"[int8-parity] {name}: {len(cpu)} quant points "
                             f"on the CPU, {len(card)} on the card")
    codes = flipped = 0
    worst = 0.0
    for i, ((q_cpu, r_cpu), (q_card, r_card)) in enumerate(zip(cpu, card)):
        flips = int((q_cpu != q_card).sum())
        codes += q_cpu.numel()
        flipped += flips
        worst = max(worst, flips / q_cpu.numel())
        if (bound == 0 and (flips or not torch.equal(r_cpu, r_card))) or (
                i == 0 and flips > bound * q_cpu.numel()):
            raise AssertionError(
                f"[int8-parity] {name}: point {i}: {flips} of "
                f"{q_cpu.numel()} codes flipped (bound {bound}), ranges "
                f"{float(r_cpu)} / {float(r_card)}")
    return len(cpu), codes, flipped, worst


def randomized(module, seed):
    """``module`` with N(0, 1/fan_in) conv kernels, small random biases
    and random inference batch norms, drawn on the CPU from ``seed``."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * fan_in ** -0.5)
                if m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
            elif hasattr(m, "running_var"):
                for t, lo, hi in ((m.weight, 0.5, 1.5),
                                  (m.running_var, 0.5, 1.5)):
                    t.copy_(torch.rand(t.shape, generator=g) * (hi - lo) + lo)
                for t in (m.bias, m.running_mean):
                    t.copy_(torch.randn(t.shape, generator=g) * 0.2)
    return module


def both_devices(module, device, run):
    """``run(module, device)`` on the CPU and on the card, with the codes
    each run quantized: ((cpu output, codes), (card output, codes))."""
    import copy

    outs = []
    for on, m in (("cpu", module), (device, copy.deepcopy(module).to(device))):
        record = []
        with recording_codes(record):
            outs.append((run(m, on), record))
    return outs


def single_tap_ssd_float_stage(variables, seed):
    """SSD variables whose conv1/conv2 kernels read one input channel at
    the centre tap times 0.5 or 1 (biases in {-8, 0, 4}): the float stage
    of the int8 path is then exact in any summation order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vgg = variables["params"]["feature_extractor"]["vgg_16"]
    for stage in ("conv1", "conv2"):
        for name, layer in vgg[stage].items():
            kh, kw, cin, cout = layer["kernel"].shape
            kernel = np.zeros((kh, kw, cin, cout), np.float32)
            kernel[kh // 2, kw // 2, np.arange(cout) % cin,
                   np.arange(cout)] = rng.choice([0.5, 1.0], cout)
            layer["kernel"] = kernel
            layer["bias"] = rng.choice([-8.0, 0.0, 4.0], cout).astype(
                np.float32)
    return variables


def paired(name, got, want, box_atol, prob_atol, share):
    """One image's detections: at least ``share`` of them pair one to one
    with an object of the same label, box (``box_atol`` px) and
    probability (``prob_atol``); ties in probability may come in either
    order. Returns (largest box difference of the pairs, unpaired)."""
    import numpy as np

    if len(got) != len(want) or not want:
        raise AssertionError(f"[int8-parity] {name}: {len(got)} detections "
                             f"on the card, {len(want)} on the CPU")
    unmatched, worst, unpaired = list(want), 0.0, 0
    for o in got:
        match = next((w for w in unmatched if w["label"] == o["label"]
                      and abs(w["prob"] - o["prob"]) <= prob_atol
                      and np.allclose(o["bbox"], w["bbox"], rtol=0,
                                      atol=box_atol)), None)
        if match is None:
            unpaired += 1
            continue
        unmatched.remove(match)
        worst = max(worst, float(np.abs(np.subtract(o["bbox"],
                                                    match["bbox"])).max()))
    if unpaired > (1 - share) * len(want):
        raise AssertionError(f"[int8-parity] {name}: {unpaired} of "
                             f"{len(want)} detections have no counterpart "
                             f"on the CPU (at most {1 - share:.0%})")
    return worst, unpaired


def hold_tail_on_served_features(cpu, card, requests):
    """The card's int8 tail against the CPU's, bitwise, on the ROI features
    of one card forward, the CPU taking the card's calibrated maxima."""
    import torch
    from luminoth_tpu_torch.models.base import quantized_tail as pq

    keys = pq.int8_stat_keys(card._model)
    pq.load_int8_stats(cpu._model, {k: card._model.get_buffer(k).cpu()
                                    for k in keys})
    captured = {}
    tail = card._model.base_network_tail
    hook = tail.register_forward_hook(lambda module, args, out: captured
                                      .update(x=args[0].clone(),
                                              y=out.clone()))
    try:
        card.predict_batch(requests)
    finally:
        hook.remove()
    with torch.inference_mode():
        want = cpu._model.base_network_tail(captured["x"].cpu())
    if not torch.equal(captured["y"].cpu(), want):
        raise AssertionError("[int8-parity] the int8 tail differs card "
                             "against CPU on the served ROI features")
    return True


def check_int8_parity(device):
    """[int8-parity]: the int8 layers on the card against the CPU, float32
    with TF32 off, small sizes: the products at served K and N (padded
    rows included) exactly; the R101 int8 tail (random batch norms) with
    its calibration and static serving bitwise, codes and ranges equal;
    the int8 trunk and SSD's int8 maps after their float layers with at
    most ``INT8_FLIP_BOUND`` of the first point's codes flipped and the
    outputs within ``INT8_MAP_RTOL``, and bitwise with SSD's float stage
    made exact; then the small ``fast`` Faster R-CNN and SSD
    through ``PredictorNetwork`` (each calibrated at load): Faster R-CNN
    maxima within ``FAST_SCALE_RTOL``, the int8 tail bitwise on a card
    forward's own ROI features, at least ``FAST_PAIRED_SHARE`` of
    the detections paired with one of the same label within
    ``FAST_BOX_ATOL`` px and ``FAST_PROB_ATOL``; SSD (exact float stage)
    maxima equal and every detection paired within ``SSD_FAST_BOX_ATOL``
    px and the 4-place rounding."""
    import numpy as np
    import torch
    from luminoth_tpu_torch.models.base import quantized_tail as pq
    from luminoth_tpu_torch.models.ssd import SSD
    from luminoth_tpu_torch.models.ssd.feature_extractor import (
        SSDFeatureExtractor,
    )
    from luminoth_tpu_torch.utils.config import Config, get_config
    from luminoth_tpu_torch.utils.predicting import PredictorNetwork
    from luminoth_tpu_torch.utils.serving import apply_serving_profile
    from luminoth_tpu_torch.utils.weights import (
        flax_variables_from_torch,
        init_variables,
        load_flax_variables,
    )

    numbers = {}
    g = torch.Generator().manual_seed(SEED)
    for m, k, n in ((1, 1152, 256), (16, 4608, 512), (4000, 4608, 512),
                    (4000, 1024, 2048)):
        rows = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g)
        w = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=g)
        if not torch.equal(pq.int8_mm(rows.to(device), w.to(device)).cpu(),
                           pq.int8_mm(rows, w)):
            raise AssertionError(f"[int8-parity] int32 accumulators differ "
                                 f"at M={m} K={k} N={n}")
    numbers["accumulators_equal"] = True

    # The R101 tail: calibrate, then static on a new input; bitwise.
    tail = randomized(pq.Int8ResNetTail(101, 1024, static_scales=True),
                      SEED).eval()
    x = torch.relu(torch.randn(INT8_PARITY_ROIS, 1024, 7, 7, generator=g))
    x = x.contiguous(memory_format=torch.channels_last)

    def calibrate_then_serve(m, on):
        with torch.inference_mode():
            with pq.calibrating(m):
                first = m(x.to(on))
            second = m(x.to(on) * 0.7)
        return (first.cpu(), second.cpu(),
                [b.cpu() for b in m.buffers()])

    (want, cpu_codes), (got, card_codes) = both_devices(
        tail, device, calibrate_then_serve)
    points, codes, _, _ = code_flips("tail", cpu_codes, card_codes, 0)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and all(map(torch.equal, got[2], want[2]))):
        raise AssertionError("[int8-parity] tail outputs or calibrated "
                             "maxima differ card against CPU")
    numbers.update(tail_points=points, tail_codes=codes, tail_flips=0,
                   tail_bitwise=True)

    # The R101 int8 trunk after its float32 root conv, dynamic.
    trunk = randomized(pq.Int8ResNetTrunk(101, 16, "block3"), SEED + 1).eval()
    images = torch.rand(2, 3, 160, 224, generator=g) * 255 - 120

    def forward(m, on):
        with torch.inference_mode():
            return m(images.to(on).contiguous(
                memory_format=torch.channels_last)).cpu()

    (want, cpu_codes), (got, card_codes) = both_devices(trunk, device,
                                                        forward)
    points, codes, flips, worst = code_flips("trunk", cpu_codes, card_codes,
                                             INT8_FLIP_BOUND)
    trunk_err = float((got - want).abs().max() / want.abs().max())
    if not trunk_err <= INT8_MAP_RTOL:
        raise AssertionError(f"[int8-parity] trunk output rel err "
                             f"{trunk_err}")
    numbers.update(trunk_points=points, trunk_flips=f"{flips}/{codes}",
                   trunk_worst_point_share=f"{worst:.2e}",
                   trunk_rel_err=f"{trunk_err:.2e}")

    # SSD's int8 maps after the float conv1/conv2: random, then exact.
    config = get_config(ssd_config("int8_parity_ssd", 3, "float32"))
    ssd_images = (torch.rand(2, 3, SSD_SIZE, SSD_SIZE, generator=g) * 255
                  - 120).contiguous(memory_format=torch.channels_last)

    def maps(m, on):
        with torch.inference_mode(), pq.calibrating(m):
            out = m(ssd_images.to(on))
        return [t.cpu() for t in out], [b.cpu() for b in m.buffers()]

    for stage in ("random", "exact"):
        variables = init_variables(config, SEED)
        if stage == "exact":
            # cuDNN may take a 3x3 conv through Winograd, inexact even for
            # single-tap kernels; PyTorch's own conv is a sum of exact
            # products with zeros.
            single_tap_ssd_float_stage(variables, SEED)
        flat = {k.replace("params/feature_extractor/", "params/"): v
                for k, v in flax_variables_from_torch(load_flax_variables(
                    SSD(config), variables)).items()
                if k.startswith("params/feature_extractor/")}
        extractor = load_flax_variables(SSDFeatureExtractor(Config(
            {"int8_trunk": True, "int8_static": True})), flat).eval()
        with torch.backends.cudnn.flags(enabled=stage == "random"):
            (want, cpu_codes), (got, card_codes) = both_devices(
                extractor, device, maps)
        bound = 0 if stage == "exact" else INT8_FLIP_BOUND
        points, codes, flips, worst = code_flips(f"ssd {stage}", cpu_codes,
                                                 card_codes, bound)
        # conv4_3's L2 normalisation sums over channels in float32: in
        # another order on the card; the other maps and the maxima bitwise.
        norm_err = float((got[0][0] - want[0][0]).abs().max()
                         / want[0][0].abs().max())
        if stage == "exact" and not (all(map(
                torch.equal, got[0][1:] + got[1], want[0][1:] + want[1]))
                and norm_err <= 1e-6):
            raise AssertionError("[int8-parity] SSD maps with the exact "
                                 "float stage differ card against CPU "
                                 f"(conv4_3_norm rel err {norm_err})")
        scale_err = max(float((a - b).abs() / b.abs().clamp(min=1e-12))
                        for a, b in zip(got[1], want[1]))
        map_err = max(float((a - b).abs().max() / b.abs().max().clamp(
            min=1e-12)) for a, b in zip(got[0], want[0]))
        if not map_err <= INT8_MAP_RTOL:
            raise AssertionError(f"[int8-parity] SSD {stage} maps rel err "
                                 f"{map_err}")
        numbers.update({f"ssd_{stage}_points": points,
                        f"ssd_{stage}_flips": f"{flips}/{codes}",
                        f"ssd_{stage}_worst_point_share": f"{worst:.2e}",
                        f"ssd_{stage}_scale_rel_err": f"{scale_err:.2e}",
                        f"ssd_{stage}_map_rel_err": f"{map_err:.2e}"})

    # The small `fast` models end to end through PredictorNetwork.
    small_config, small_variables, _ = small_parity_model()
    fast = apply_serving_profile(small_config, "fast")
    # [parity]'s small RPN budgets, so the CPU side stays quick, and the
    # top FAST_PARITY_DETECTIONS per image (the rest tie within 1e-3).
    fast.model.rpn.proposals.pre_nms_top_n = 400
    fast.model.rpn.proposals.post_nms_top_n = 50
    fast.model.rcnn.proposals.total_max_detections = FAST_PARITY_DETECTIONS
    rng = np.random.default_rng(SEED + 16)
    frcnn_images = [rng.integers(0, 256, (150, 210, 3), dtype=np.uint8)
                    for _ in range(2)]
    ssd_fast = apply_serving_profile(config, "fast")
    ssd_variables = single_tap_ssd_float_stage(init_variables(config, SEED),
                                               SEED)
    ssd_requests = [rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
                    for _ in range(2)]
    for name, cfg, variables, requests, box_atol, prob_atol, share in (
            ("frcnn", fast, small_variables, frcnn_images, FAST_BOX_ATOL,
             FAST_PROB_ATOL, FAST_PAIRED_SHARE),
            ("ssd", ssd_fast, ssd_variables, ssd_requests,
             SSD_FAST_BOX_ATOL, PROB_ATOL, 1.0)):
        results, stats, networks = [], [], []
        for on in ("cpu", device):
            # SSD's float stage exact on the card too (see above).
            with torch.backends.cudnn.flags(enabled=name == "frcnn"):
                networks.append(PredictorNetwork(cfg, variables=variables,
                                                 device=on))
                results.append(networks[-1].predict_batch(requests))
            stats.append({k: float(v) for k, v in flax_variables_from_torch(
                networks[-1]._model).items() if k.startswith("int8_stats/")})
        if name == "frcnn":
            numbers["frcnn_fast_tail_on_served_features_bitwise"] = (
                hold_tail_on_served_features(*networks, requests))
        want_stats, got_stats = stats
        scale_err = max(abs(got_stats[k] - v) / abs(v)
                        for k, v in want_stats.items())
        rtol = FAST_SCALE_RTOL if name == "frcnn" else 0.0
        if set(got_stats) != set(want_stats) or scale_err > rtol:
            raise AssertionError(f"[int8-parity] {name} fast: calibrated "
                                 f"maxima rel err {scale_err} (bound {rtol})")
        box_err, detections, unpaired = 0.0, 0, 0
        for want, got in zip(*results):
            err, left = paired(f"{name} fast", got, want, box_atol,
                               prob_atol, share)
            box_err, unpaired = max(box_err, err), unpaired + left
            detections += len(want)
        numbers.update({f"{name}_fast_detections": detections,
                        f"{name}_fast_unpaired": unpaired,
                        f"{name}_fast_scale_rel_err": f"{scale_err:.2e}",
                        f"{name}_fast_box_max_err_px": box_err})
    phase("int8-parity", dtype="float32", tf32=False,
          flip_bound=INT8_FLIP_BOUND, **numbers)


def fast_config(path):
    """The config of ``path`` under the ``fast`` serving profile."""
    from luminoth_tpu_torch.utils.config import get_config
    from luminoth_tpu_torch.utils.serving import apply_serving_profile

    return apply_serving_profile(get_config(path), "fast")


def forward_pair(networks, batch, canvas):
    """Device ms of each network's forward on one uploaded uint8 batch,
    in turns (a, b, b, a), and each one's peak memory in GB."""
    import numpy as np
    import torch

    images = torch.from_numpy(np.random.default_rng(SEED + 17).integers(
        0, 256, (batch,) + tuple(canvas) + (3,), dtype=np.uint8)).to(
        networks[0].device)
    im_shape = torch.tensor([canvas] * batch, dtype=torch.float32,
                            device=images.device)
    times = {i: [] for i in range(len(networks))}
    peaks = {}
    for i in (0, 1, 1, 0):
        torch.cuda.reset_peak_memory_stats()
        times[i].append(cuda_ms(lambda: networks[i].forward(images,
                                                            im_shape),
                                5, warmup=1))
        peaks[i] = torch.cuda.max_memory_allocated() / 1e9
    return [sum(t) / len(t) for t in times.values()], [peaks[0], peaks[1]]


def fast_serve(device, card, accurate):
    """[fast-serve]: the ``fast`` profile at full width (R101, 80 classes,
    bf16, b8 608x800, uint8 transfer, RPN 6000/1000, ``int8_tail`` with
    static scales calibrated at load) through ``PredictorNetwork``: one
    warm-up and three measured batches of 8 480x640 images and one
    single image, K1 twice and K2 once per forward; one more batch with
    K1 (RPN G=8 N=6000 keep 1000, per class G=640 N<=512) and K2 (R=1000)
    held against their plain versions on its own tensors; then the device
    time of its forward beside [serve]'s ``accurate`` forward in turns on
    one uploaded batch, with each one's peak memory."""
    import numpy as np
    from luminoth_tpu_torch.utils.predicting import PredictorNetwork
    from luminoth_tpu_torch.utils.weights import init_variables

    path = serve_config("resnet_v1_101", 80, "bfloat16", CANVAS)
    config = fast_config(path)
    t0 = time.perf_counter()
    network = PredictorNetwork(config, variables=init_variables(
        config, SEED), device=device)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 18)
    requests = [[rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
                 for _ in range(BATCH)] for _ in range(4)]
    single = rng.integers(0, 256, (600, 800, 3), dtype=np.uint8)
    network.predict_batch(requests[0])  # warm-up
    counts = {}
    read = path_launches()
    with counting_k2_k3(counts):
        latencies, results = [], []
        for batch in requests[1:]:
            t = time.perf_counter()
            results.extend(network.predict_batch(batch))
            latencies.append(time.perf_counter() - t)
        results.append(network.predict_image(single))
        launches = read()
    forwards = len(requests)
    check_forwards("fast-serve", launches, forwards)
    if counts["k3"]:
        raise AssertionError(f"[fast-serve] K3 launched {counts['k3']} times")
    detections = check_detections("fast-serve", results, 80, 300, 0.0)

    k1s, k2s, survivors = [], [], []
    with capturing_k1(k1s), capturing_k2(k2s):
        network.predict_batch(requests[1])
    shapes = [(c[0].shape[0], c[0].shape[1], c[3]) for c in k1s]
    rpn, anchors = config.model.rpn.proposals, config.model.anchors
    candidates = min(rpn.pre_nms_top_n, len(anchors.ratios)
                     * len(anchors.scales)
                     * math.ceil(CANVAS[0] / anchors.stride)
                     * math.ceil(CANVAS[1] / anchors.stride))
    if shapes[0] != (BATCH, candidates, rpn.post_nms_top_n) or len(
            shapes) != 2 or len(k2s) != 1:
        raise AssertionError(f"[fast-serve] K1 at {shapes}, K2 "
                             f"{len(k2s)} launches")
    k1_rpn = hold_k1(k1s[:1], "fast-serve", survivors=survivors)
    k1_class = hold_k1(k1s[1:], "fast-serve", survivors=survivors)
    k2_errors = []
    k2 = hold_k2(k2s, "fast-serve", errors=k2_errors, library=True)
    (accurate_ms, fast_ms), (accurate_gb, fast_gb) = forward_pair(
        [accurate, network], BATCH, CANVAS)
    phase("fast-serve", model="resnet_v1_101", classes=80, dtype="bfloat16",
          canvas=f"{CANVAS[0]}x{CANVAS[1]}", batch=BATCH, transfer="uint8",
          rpn=f"{rpn.pre_nms_top_n}/{rpn.post_nms_top_n}", int8="tail",
          forwards=forwards, k1_launches=launches["k1"],
          k2_launches=launches["k2"], k3_launches=counts["k3"],
          detections=detections, setup_s=f"{setup_s:.1f}",
          calibration_s=f"{network.int8_calibration_s:.2f}",
          request_latency_ms="/".join(f"{1000 * t:.1f}" for t in latencies),
          forward_ms=f"{fast_ms:.2f}",
          images_per_s=f"{1000 * BATCH / fast_ms:.2f}",
          accurate_forward_ms=f"{accurate_ms:.2f}",
          peak_gb=f"{fast_gb:.1f}", accurate_peak_gb=f"{accurate_gb:.1f}",
          k1_rpn=f"{shapes[0][0]}x{shapes[0][1]}", k1_rpn_equal=True,
          k1_rpn_survivors=survivors[0], k1_rpn_ms=f"{k1_rpn[0]:.4f}",
          k1_rpn_plain_ms=f"{k1_rpn[1]:.4f}",
          k1_rpn_bound_ms=f"{k1_rpn[2]:.4f}",
          k1_class=f"{shapes[1][0]}x{shapes[1][1]}", k1_class_equal=True,
          k1_class_ms=f"{k1_class[0]:.4f}",
          k1_class_plain_ms=f"{k1_class[1]:.4f}",
          k1_class_bound_ms=f"{k1_class[2]:.4f}",
          k2_rois=k2s[0][1].shape[1], k2_max_abs_err=k2_errors[0],
          k2_ms=f"{k2['ms']:.4f}", k2_plain_ms=f"{k2['plain_ms']:.4f}",
          k2_bound_ms=f"{k2['bound_ms']:.4f}",
          k2_library_ms=f"{k2['library_ms']:.4f}", card=f"'{card}'")
    k1_times = {(BATCH, candidates, "fast forward"): k1_rpn,
                (shapes[1][0], shapes[1][1], "fast forward"): k1_class}
    return {**launches, **counts}, k1_times, {
        "rois": k2s[0][1].shape[1], "on": "fast forward",
        "max_abs_err": k2_errors[0], **k2}


def ssd_fast_serve(device, card):
    """[ssd-fast-serve]: SSD300 under the ``fast`` profile (``int8_trunk``
    with static scales calibrated at load), bf16, uint8, 20 classes, the
    heads of [ssd-serve], through ``PredictorNetwork``; at b32 and b128 a
    warm-up, then one measured batch of 375x500 images with K1 once (G=B,
    N=1000) held against its plain version on its own tensors, and the
    device time of its forward beside the float (``accurate``) network's
    in turns on one uploaded batch. K2 and K3 must not launch."""
    import numpy as np
    from luminoth_tpu_torch.utils.config import get_config
    from luminoth_tpu_torch.utils.predicting import PredictorNetwork

    path = ssd_config("ssd_serve", SSD_CLASSES, "bfloat16",
                      dataset={"transfer_dtype": "uint8"})
    variables = rescaled_ssd_variables(get_config(path), device)
    accurate = PredictorNetwork(get_config(path), variables=variables,
                                device=device)
    t0 = time.perf_counter()
    network = PredictorNetwork(fast_config(path), variables=variables,
                               device=device)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 19)
    launches, counts, k1_times = 0, {}, {}
    for batch in SSD_SERVE_BATCHES:
        images = [rng.integers(0, 256, (375, 500, 3), dtype=np.uint8)
                  for _ in range(batch)]
        network.predict_batch(images)  # warm-up
        captured = []
        with capturing_k1(captured) as k1, counting_k2_k3(counts):
            t = time.perf_counter()
            results = network.predict_batch(images)
            request_s = time.perf_counter() - t
        shapes = [tuple(c[0].shape[:2]) + (c[3],) for c in captured]
        if k1.launches != 1 or shapes != [(batch, 1000, 100)]:
            raise AssertionError(f"[ssd-fast-serve] b{batch}: K1 launched "
                                 f"{k1.launches} times at {shapes}")
        launches += k1.launches
        detections = check_detections("ssd-fast-serve", results,
                                      SSD_CLASSES, 100, 0.5)
        if detections == 0:
            raise AssertionError(f"[ssd-fast-serve] b{batch}: no detection")
        k1_times[(batch, 1000, "ssd fast forward")] = k1 = hold_k1(
            captured, "ssd-fast-serve")
        (accurate_ms, fast_ms), (accurate_gb, fast_gb) = forward_pair(
            [accurate, network], batch, (SSD_SIZE, SSD_SIZE))
        phase("ssd-fast-serve", model="ssd_vgg16", classes=SSD_CLASSES,
              dtype="bfloat16", canvas=f"{SSD_SIZE}x{SSD_SIZE}", batch=batch,
              transfer="uint8", int8="trunk", k1_launches=1,
              k1_shape=f"{batch}x1000", k1_equal=True,
              k1_valid_per_group=valid_per_group(captured),
              detections=detections, forward_ms=f"{fast_ms:.2f}",
              images_per_s=f"{1000 * batch / fast_ms:.2f}",
              accurate_forward_ms=f"{accurate_ms:.2f}",
              peak_gb=f"{fast_gb:.1f}", accurate_peak_gb=f"{accurate_gb:.1f}",
              request_ms=f"{1000 * request_s:.1f}",
              calibration_s=f"{network.int8_calibration_s:.2f}",
              setup_s=f"{setup_s:.1f}", k1_ms=f"{k1[0]:.4f}",
              k1_plain_ms=f"{k1[1]:.4f}", k1_bound_ms=f"{k1[2]:.4f}",
              card=f"'{card}'")
    no_k2_k3("ssd-fast-serve", counts)
    return {"k1": launches, **counts}, k1_times


def fast_predict_phase(device):
    """[fast-predict]: a one-image request through the ``predict`` command
    with ``--profile fast`` from [train]'s and [ssd-train]'s checkpoints
    (the predictor calibrates at load: two forwards each). SSD's 1x1 map
    has one row, padded to 17 for ``torch._int_mm``."""
    import numpy as np
    from click.testing import CliRunner
    from PIL import Image
    from luminoth_tpu_torch import predict as predictor

    image = os.path.join(BUILD, "fast_predict.jpg")
    Image.fromarray(np.random.default_rng(SEED + 20).integers(
        0, 256, (480, 640, 3), dtype=np.uint8)).save(image, quality=90)
    ssd_path = ssd_config("ssd_fast_predict", SSD_CLASSES, "bfloat16",
                          train={"job_dir": os.path.join(BUILD, "jobs"),
                                 "run_name": "ssd"})
    total = {}
    for name, path, per_forward in (
            ("fasterrcnn", checkpoint_config("fast_predict"),
             {"k1": 2, "k2": 1, "k3": 0}),
            ("ssd", ssd_path, {"k1": 1, "k2": 0, "k3": 0})):
        out = os.path.join(BUILD, f"fast_predict_{name}.jsonl")
        counts = {}
        read = path_launches()
        with counting_k2_k3(counts):
            result = CliRunner().invoke(predictor.predict, [
                image, "-c", path, "--min-prob", "0", "--profile", "fast",
                "--device", str(device), "-f", out])
        launches = {"k1": read()["k1"], **counts}
        if result.exit_code != 0:
            raise AssertionError(f"[fast-predict] {name}: exit "
                                 f"{result.exit_code}: {result.output}"
                                 ) from result.exception
        if launches != {k: 2 * v for k, v in per_forward.items()}:
            raise AssertionError(f"[fast-predict] {name}: launches "
                                 f"{launches} over the calibration and the "
                                 f"request (want {per_forward} each)")
        with open(out) as f:
            lines = [json.loads(line) for line in f]
        if len(lines) != 1 or not lines[0]["objects"]:
            raise AssertionError(f"[fast-predict] {name}: {lines}")
        classes = 80 if name == "fasterrcnn" else SSD_CLASSES
        check_detections("fast-predict", [lines[0]["objects"]], classes,
                         300, 0.0)
        phase("fast-predict", model=name, image="480x640",
              detections=len(lines[0]["objects"]),
              k1_launches=launches["k1"], k2_launches=launches["k2"],
              k3_launches=launches["k3"])
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


@contextlib.contextmanager
def zoo_home():
    """A fresh ``LUMI_HOME`` under ``build/`` and no remote index for the
    block, so that the machine's own home is not written."""
    import shutil

    keys = ("LUMI_HOME", "LUMI_REMOTE_INDEX_URL")
    saved = {key: os.environ.get(key) for key in keys}
    home = os.path.join(BUILD, "zoo_home")
    shutil.rmtree(home, ignore_errors=True)
    os.environ["LUMI_HOME"] = home
    os.environ.pop("LUMI_REMOTE_INDEX_URL", None)
    try:
        yield home
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def invoke(command, args):
    """A click command with ``args``, in process; raises unless it exits
    with 0."""
    from click.testing import CliRunner

    result = CliRunner().invoke(command, [str(a) for a in args])
    if result.exit_code != 0:
        raise AssertionError(f"{command.name} {args[0]}: exit "
                             f"{result.exit_code}: {result.output}"
                             ) from result.exception
    return result


def zoo_cli(args):
    """``python -m luminoth_tpu_torch checkpoint <args>``, in process."""
    from luminoth_tpu_torch.tools.checkpoint import checkpoint

    return invoke(checkpoint, args)


def web_request(device, args, body):
    """The ``server web`` command with ``args`` in process (its server
    started without blocking), one multipart POST of the JPEG ``body``;
    returns the answer's objects. The server is stopped after."""
    import urllib.request

    from luminoth_tpu_torch.tools.server import web

    servers, run_server = [], web.run_server

    def non_blocking(*a, **kw):
        servers.append(run_server(*a, **{**kw, "block": False}))
        return servers[-1]

    web.run_server = non_blocking
    try:
        invoke(web.web, [*args, "--port", "0", "--batch-size", "1",
                         "--device", str(device)])
    finally:
        web.run_server = run_server
    httpd = servers[0]
    try:
        if not httpd.state.ready.wait(600) or httpd.state.network is None:
            raise AssertionError(f"server web: model not loaded: "
                                 f"{httpd.state.error}")
        boundary = "smokeboundary"
        data = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="image"; filename="q.jpg"\r\n'
                f"Content-Type: image/jpeg\r\n\r\n").encode()
        data += body + f"\r\n--{boundary}--\r\n".encode()
        request = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/api/fasterrcnn/"
            f"predict/", data=data, headers={
                "Content-Type": f"multipart/form-data; boundary={boundary}"})
        with urllib.request.urlopen(request, timeout=300) as response:
            return json.load(response)["objects"]
    finally:
        web.stop_server(httpd)


def zoo_phase(device, card):
    """[zoo]: [train]'s checkpoint through the checkpoint zoo, in a fresh
    ``LUMI_HOME``: ``checkpoint create``, ``export``, ``build-index`` into
    a ``file://`` index and ``delete`` of the local copy; then
    ``Detector(checkpoint=alias)`` refreshes the index, downloads the
    bundle and serves two batches of 8 at 608x800, which must equal, bit
    for bit, a ``PredictorNetwork`` on [train]'s checkpoint itself (cuDNN
    deterministic for both); K1 and K2 held on a served forward's own
    tensors; then ``predict --checkpoint`` and ``server web
    --checkpoint`` answer one request each. Counts K1 and K2 over the
    Detector's forwards and the two commands'."""
    import io
    import shutil

    import numpy as np
    import torch
    from PIL import Image
    from luminoth_tpu_torch import Detector
    from luminoth_tpu_torch import predict as predictor
    from luminoth_tpu_torch.tools import checkpoint as zoo
    from luminoth_tpu_torch.tools.server.web import MIN_PROB_FOR_FRONTEND
    from luminoth_tpu_torch.utils.config import get_config
    from luminoth_tpu_torch.utils.predicting import PredictorNetwork

    path = checkpoint_config("zoo")
    export = os.path.join(BUILD, "zoo_export")
    shutil.rmtree(export, ignore_errors=True)
    os.makedirs(export)
    rng = np.random.default_rng(SEED + 21)
    batches = [[rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
                for _ in range(BATCH)] for _ in range(2)]
    jpeg = io.BytesIO()
    Image.fromarray(batches[0][0]).save(jpeg, "JPEG", quality=90)
    image_path = os.path.join(BUILD, "zoo_query.jpg")
    with open(image_path, "wb") as f:
        f.write(jpeg.getvalue())
    deterministic = torch.backends.cudnn.deterministic
    with zoo_home():
        t0 = time.perf_counter()
        zoo_cli(["create", path, "--alias", ZOO_ALIAS])
        (entry,) = zoo.read_checkpoint_db()["checkpoints"]
        bundle = zoo.get_checkpoint_path(entry["id"])
        weights = [n for n in os.listdir(bundle) if n.endswith(".msgpack")]
        bundle_mb = os.path.getsize(os.path.join(bundle, weights[0])) / 1e6
        zoo_cli(["export", ZOO_ALIAS, "--output", export])
        zoo_cli(["build-index", export])
        zoo_cli(["delete", ZOO_ALIAS])
        publish_s = time.perf_counter() - t0
        if zoo.read_checkpoint_db()["checkpoints"] or os.path.exists(bundle):
            raise AssertionError("[zoo] delete left the bundle")
        os.environ["LUMI_REMOTE_INDEX_URL"] = "file://" + os.path.join(
            export, "index.json")
        torch.backends.cudnn.deterministic = True
        try:
            t0 = time.perf_counter()
            detector = Detector(checkpoint=ZOO_ALIAS, device=device,
                                prob=0.0)
            load_s = time.perf_counter() - t0
            (entry,) = zoo.read_checkpoint_db()["checkpoints"]
            labels = zoo.get_checkpoint_class_labels(ZOO_ALIAS)
            if entry["status"] != "DOWNLOADED" or len(labels) != 80:
                raise AssertionError(f"[zoo] entry {entry}, labels "
                                     f"{labels and len(labels)}")
            read = path_launches()
            got = [detector.predict(batch) for batch in batches]
            launches = read()
            check_forwards("zoo", launches, len(batches))
            reference = PredictorNetwork(get_config(path),
                                         class_labels=labels, device=device)
            want = [reference.predict_batch(batch, pad_to=BATCH)
                    for batch in batches]
            if got != want:
                raise AssertionError(
                    "[zoo] Detector(checkpoint=) differs from "
                    "PredictorNetwork on the same checkpoint")
            del reference
            detections = check_detections(
                "zoo", [objects for batch in got for objects in batch], 80,
                300, 0.0, labels=labels)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        k1s, k2s = [], []
        with capturing_k1(k1s), capturing_k2(k2s):
            detector.predict(batches[1])
        hold_k1(k1s, "zoo", timed=False)
        k2_errors = []
        hold_k2(k2s, "zoo", errors=k2_errors, timed=False)
        del detector

        read = path_launches()
        out = os.path.join(BUILD, "zoo_predict.jsonl")
        result = invoke(predictor.predict, [
            image_path, "--checkpoint", ZOO_ALIAS, "--min-prob", "0",
            "--device", str(device), "-f", out])
        with open(out) as f:
            predicted = json.loads(f.readline())["objects"]
        served = web_request(device, ["--checkpoint", ZOO_ALIAS],
                             jpeg.getvalue())
        commands = read()
        check_forwards("zoo-commands", commands, 2)
        # The web command serves at its frontend floor (min_prob 0.01):
        # an early checkpoint may have no detection above it.
        for name, objects, floor in (("predict", predicted, 0.0),
                                     ("web", served, MIN_PROB_FOR_FRONTEND)):
            if (name == "predict" and not objects) or any(
                    o["label"] not in labels or o["prob"] < floor
                    for o in objects):
                raise AssertionError(f"[zoo] {name} --checkpoint answered "
                                     f"{objects[:2]} ({result.output})")
    launches = {k: launches[k] + commands[k] for k in launches}
    phase("zoo", model="resnet_v1_101", classes=80, dtype="bfloat16",
          canvas=f"{CANVAS[0]}x{CANVAS[1]}", batch=BATCH,
          bundle_mb=f"{bundle_mb:.1f}", publish_s=f"{publish_s:.1f}",
          download_and_load_s=f"{load_s:.1f}", forwards=len(batches) + 2,
          k1_launches=launches["k1"], k2_launches=launches["k2"],
          detections=detections, equal_to_predictor=True,
          k1_held=len(k1s), k2_max_abs_err=k2_errors[0],
          predict_objects=len(predicted), web_objects=len(served),
          card=f"'{card}'")
    return launches


def backbones_phase(device, card):
    """[backbones]: Faster R-CNN on each other backbone at full width (80
    classes, bf16, b8 608x800, [serve]'s budgets, random weights): first
    the card against the CPU at a small size (f32, TF32 off, the same
    detections), then one counted ``predict_batch`` of 8 480x640 images,
    K1 and K2 held on another forward's own tensors (K2 at VGG-16's 512
    channels also timed beside its plain version, its bound and the
    library form), and the device time of a forward on an uploaded batch
    with its peak memory."""
    import numpy as np
    import torch
    from luminoth_tpu_torch.utils.config import get_config
    from luminoth_tpu_torch.utils.predicting import PredictorNetwork
    from luminoth_tpu_torch.utils.weights import init_variables

    rng = np.random.default_rng(SEED + 23)
    batch = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
             for _ in range(BATCH)]
    images = torch.from_numpy(np.stack([
        rng.integers(0, 256, (CANVAS[0], CANVAS[1], 3), dtype=np.uint8)
        for _ in range(BATCH)])).to(device)
    im_shape = torch.tensor([CANVAS] * BATCH, dtype=torch.float32,
                            device=device)
    total = {"k1": 0, "k2": 0}
    k2_shapes = []
    for name, architecture, extra in BACKBONES:
        check_small_parity(device, architecture, extra,
                           name="backbones-parity")
        config = get_config(serve_config(architecture, 80, "bfloat16",
                                         CANVAS, base_network=extra))
        t0 = time.perf_counter()
        network = PredictorNetwork(config, variables=init_variables(
            config, SEED), device=device)
        setup_s = time.perf_counter() - t0
        read = path_launches()
        results = network.predict_batch(batch)
        launches = read()
        check_forwards(f"backbones {name}", launches, 1)
        detections = check_detections(f"backbones {name}", results, 80, 300,
                                      0.0)
        k1s, k2s, survivors = [], [], []
        with capturing_k1(k1s), capturing_k2(k2s):
            network.predict_batch(batch)
        hold_k1(k1s, f"backbones {name}", survivors=survivors, timed=False)
        k2_errors = []
        vgg = architecture == "vgg_16"
        k2 = hold_k2(k2s, f"backbones {name}", errors=k2_errors, timed=vgg,
                     library=vgg)
        channels = k2s[0][0].shape[-1]
        if vgg:
            k2_shapes.append({"rois": k2s[0][1].shape[1], "channels": channels,
                              "on": "vgg_16 forward",
                              "max_abs_err": k2_errors[0], **k2})
        del k1s, k2s
        torch.cuda.reset_peak_memory_stats()
        forward_ms = cuda_ms(lambda: network.forward(images, im_shape), 3,
                             warmup=1)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        total = {k: total[k] + launches[k] for k in total}
        k2_numbers = {} if not vgg else {
            "k2_ms": f"{k2['ms']:.4f}", "k2_plain_ms": f"{k2['plain_ms']:.4f}",
            "k2_bound_ms": f"{k2['bound_ms']:.4f}",
            "k2_library_ms": f"{k2['library_ms']:.4f}"}
        phase("backbones", model=name, architecture=architecture,
              **(extra or {}), classes=80, dtype="bfloat16",
              canvas=f"{CANVAS[0]}x{CANVAS[1]}", batch=BATCH,
              k1_launches=launches["k1"], k2_launches=launches["k2"],
              detections=detections, k1_rpn_survivors=survivors[0],
              k2_channels=channels, k2_max_abs_err=k2_errors[0],
              **k2_numbers, setup_s=f"{setup_s:.1f}",
              forward_ms=f"{forward_ms:.2f}",
              images_per_s=f"{1000 * BATCH / forward_ms:.2f}",
              peak_gb=f"{peak_gb:.1f}", card=f"'{card}'")
        del network
        torch.cuda.empty_cache()
    return total, k2_shapes


def torchvision_state(architecture, seed):
    """A seeded state dict in torchvision's layout: ResNet-101's or
    VGG-16's convs drawn normal with std 1/sqrt(fan in), batch norms near
    the identity. Stands in for an ImageNet download (no network)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    state = {}

    def conv(key, cout, cin, k, bias=False):
        state[f"{key}.weight"] = torch.from_numpy(
            rng.standard_normal((cout, cin, k, k), dtype=np.float32)
            / np.float32(math.sqrt(cin * k * k)))
        if bias:
            state[f"{key}.bias"] = torch.zeros(cout)

    def bn(key, c):
        state[f"{key}.weight"] = torch.ones(c)
        state[f"{key}.bias"] = torch.zeros(c)
        state[f"{key}.running_mean"] = torch.from_numpy(
            rng.normal(0, 0.1, c).astype(np.float32))
        state[f"{key}.running_var"] = torch.from_numpy(
            rng.uniform(0.8, 1.2, c).astype(np.float32))

    if architecture == "vgg_16":
        cin, index = 3, 0
        for reps, cout in ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)):
            for _ in range(reps):
                conv(f"features.{index}", cout, cin, 3, bias=True)
                cin, index = cout, index + 2
            index += 1  # the max-pool
        return state
    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    depth_in = 64
    for layer, units in enumerate((3, 4, 23, 3), start=1):
        base = 64 * 2 ** (layer - 1)
        for unit in range(units):
            key = f"layer{layer}.{unit}"
            conv(f"{key}.conv1", base, depth_in, 1)
            conv(f"{key}.conv2", base, base, 3)
            conv(f"{key}.conv3", base * 4, base, 1)
            bn(f"{key}.bn1", base)
            bn(f"{key}.bn2", base)
            bn(f"{key}.bn3", base * 4)
            if unit == 0:
                conv(f"{key}.downsample.0", base * 4, depth_in, 1)
                bn(f"{key}.downsample.1", base * 4)
            depth_in = base * 4
    return state


def pretrained_train_phase(device, card):
    """[pretrained-train]: ``checkpoint convert-backbone`` of a seeded
    torchvision-layout VGG-16, then ``train.run`` of Faster R-CNN on
    ``vgg_16`` from it for 3 steps (80 classes, bf16, b8 608x800); the
    same for a torchvision-layout ResNet-101 under ``torchvision_compat``.
    The converted weights must be in the trained model where they do not
    train; K1, K2 and K3 once per step; K2 and K3 held on a step's own
    tensors, and at VGG-16's 512 channels timed beside their plain
    versions and bounds."""
    import shutil

    import numpy as np
    import torch
    from luminoth_tpu_torch import train as trainer
    from luminoth_tpu_torch.ops import nms, roi_align
    from luminoth_tpu_torch.utils.config import get_config
    from luminoth_tpu_torch.utils.synthetic import write_synthetic_records

    folder = os.path.join(BUILD, "pretrained")
    os.makedirs(folder, exist_ok=True)
    data, _ = write_synthetic_records(os.path.join(BUILD, "data"),
                                      TRAIN_IMAGES, 80, SEED + 6)
    jobs = os.path.join(BUILD, "jobs")
    total = {"k1": 0, "k2": 0, "k3": 0}
    shapes = {}
    for name, architecture, base_network, probe in PRETRAINED:
        pth = os.path.join(folder, f"{name}.pth")
        npz = os.path.join(folder, f"{name}.npz")
        torch.save(torchvision_state(architecture, SEED + 31), pth)
        t0 = time.perf_counter()
        zoo_cli(["convert-backbone", pth, npz, "--architecture",
                 architecture])
        convert_s = time.perf_counter() - t0
        shutil.rmtree(os.path.join(jobs, name), ignore_errors=True)
        config = get_config(train_config(
            os.path.join(BUILD, f"{name}.yml"), 80, "bfloat16", CANVAS, {
                "train": {"job_dir": jobs, "run_name": name},
                "dataset": {"dir": data},
                "model": {"base_network": {
                    "architecture": architecture, "weights": npz,
                    **base_network}}}))
        k2s, k3s = [], []
        nms.nms_alive_cuda.launches = 0
        t0 = time.perf_counter()
        with capturing_k2(k2s) as k2_capture, capturing_k3(k3s) as k3_capture:
            state = trainer.run(config, max_steps=PRETRAINED_STEPS,
                                device=device)
        wall_s = time.perf_counter() - t0
        launches = {"k1": nms.nms_alive_cuda.launches,
                    "k2": k2_capture.launches, "k3": k3_capture.launches}
        losses = [h["total_loss"] for h in state.history]
        if state.step != PRETRAINED_STEPS or launches != {
                k: PRETRAINED_STEPS for k in launches} or not all(
                map(math.isfinite, losses)):
            raise AssertionError(f"[pretrained-train] {name}: step "
                                 f"{state.step}, launches {launches}, "
                                 f"losses {losses}")
        # A tensor that does not train (frozen by fine_tune_from, or a
        # batch-norm statistic) still holds the converted value.
        module, attr, key, transpose = probe
        got = getattr(state.model.base_network.get_submodule(module), attr)
        want = torch.from_numpy(np.load(npz)[key])
        if transpose:
            want = want.permute(3, 2, 0, 1)
        if not torch.equal(got.detach().cpu(), want):
            raise AssertionError(f"[pretrained-train] {name}: {key} is not "
                                 f"the converted value")
        k2_errors = []
        k2 = hold_k2(k2s, "pretrained-train", errors=k2_errors,
                     library=True)
        fm, boxes, grad, s = k3s[0]
        scale = unit_scale(grad)
        k3 = hold_k3(fm, boxes, grad * scale, s)
        k3_ms = cuda_ms(lambda: roi_align.roi_crop_pool_backward_cuda(
            fm, boxes, grad, s), 10, warmup=2)
        k3_plain_ms = cuda_ms(
            lambda: roi_align.roi_crop_pool_backward_reference(
                fm, boxes, grad, s), 2)
        k3_bound_ms, k3_bound_by = k3_bound(fm, boxes, grad)
        channels = fm.shape[-1]
        on = f"{name} train step"
        shapes[name] = (
            {"rois": boxes.shape[1], "channels": channels, "on": on,
             "max_abs_err": max(k2_errors), **k2},
            {"rois": boxes.shape[1], "channels": channels, "on": on,
             "max_abs_err": k3["max_abs_err"], "ms": k3_ms,
             "plain_ms": k3_plain_ms, "bound_ms": k3_bound_ms,
             "bound_by": k3_bound_by, "library_ms": None})
        total = {k: total[k] + launches[k] for k in total}
        steady = [h["device_ms"] for h in state.history[1:]]
        phase("pretrained-train", model=name, architecture=architecture,
              **base_network, classes=80, dtype="bfloat16",
              canvas=f"{CANVAS[0]}x{CANVAS[1]}", batch=BATCH,
              steps=state.step, convert_s=f"{convert_s:.1f}",
              k1_launches=launches["k1"], k2_launches=launches["k2"],
              k3_launches=launches["k3"], converted_value_kept=True,
              losses="/".join(f"{v:.4f}" for v in losses),
              steady_step_ms=f"{sum(steady) / len(steady):.2f}",
              wall_s=f"{wall_s:.1f}", k2_channels=channels,
              k2_max_abs_err=max(k2_errors), k2_ms=f"{k2['ms']:.4f}",
              k2_plain_ms=f"{k2['plain_ms']:.4f}",
              k2_bound_ms=f"{k2['bound_ms']:.4f}",
              k2_library_ms=f"{k2['library_ms']:.4f}",
              k3_max_abs_err=k3["max_abs_err"],
              k3_identity_rel_err=k3["identity_rel_err"],
              k3_cotangent_scale=scale, k3_ms=f"{k3_ms:.4f}",
              k3_plain_ms=f"{k3_plain_ms:.4f}",
              k3_bound_ms=f"{k3_bound_ms:.4f}", k3_bound_by=k3_bound_by,
              card=f"'{card}'")
        del state, k2s, k3s, fm, boxes, grad
        torch.cuda.empty_cache()
    return total, shapes


def unit_scale(grad):
    """The power of two (exact in bf16) that brings the largest magnitude
    of the cotangents ``grad`` into [1, 2)."""
    g_max = float(grad.abs().max())
    if not 0 < g_max < math.inf:
        raise AssertionError(f"train-step ROI cotangents of max {g_max}")
    return 2.0 ** -math.floor(math.log2(g_max))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from luminoth_tpu_torch import _build

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    phase("device", card=f"'{card}'",
          capability=".".join(map(str, torch.cuda.get_device_capability(0))),
          torch=torch.__version__, cuda=torch.version.cuda,
          count=torch.cuda.device_count())

    # One nvcc per source, all started together; roi_align.cu holds K2
    # and K3.
    from luminoth_tpu_torch.ops import nms, roi_align

    def first_load(item):
        name, load = item
        t = time.perf_counter()
        load()
        return name, time.perf_counter() - t

    loaders = {"nms": nms.load_library, "roi_align": roi_align.load_library}
    with ThreadPoolExecutor(len(loaders)) as pool:
        for name, seconds in pool.map(first_load, loaders.items()):
            phase("build", source=f"luminoth_tpu_torch/csrc/{name}.cu",
                  library=os.path.relpath(_build.library_path(name), HERE),
                  seconds=f"{seconds:.1f}")

    k1_err, k1_times = check_k1(device)
    k1_times.update(check_k1_ssd(device))
    k2_err, k2 = check_k2(device)
    torch.cuda.empty_cache()
    k3_err, k3_times = check_k3(device)
    torch.cuda.empty_cache()
    check_small_parity(device)
    check_ssd_parity(device)
    served, detector = serve(device, card)
    recheck_on_served_tensors(detector, device)
    fast, fast_k1, fast_k2 = fast_serve(device, card, detector._network)
    k1_times.update(fast_k1)
    del detector
    torch.cuda.empty_cache()
    check_train_parity(device)
    trained, captured = train(device, card)
    k3_err = max(k3_err, recheck_k3_on_trained_tensors(captured))
    del captured
    torch.cuda.empty_cache()
    paths = {"serve": served, "fast": fast, "train": trained,
             "eval": eval_phase(device, card)}
    check_eval_parity(device)
    paths["predict"] = predict_phase(device)
    paths["serve_latency"] = serve_latency(device, card)
    paths["web"] = web_phase(device, card)
    torch.cuda.empty_cache()
    paths["zoo"] = zoo_phase(device, card)
    torch.cuda.empty_cache()
    paths["backbones"], k2_backbones = backbones_phase(device, card)
    paths["pretrained_train"], pretrained = pretrained_train_phase(
        device, card)
    paths["ssd_serve"], _ = ssd_serve(device, card)
    torch.cuda.empty_cache()
    paths["ssd_fast"], ssd_fast_k1 = ssd_fast_serve(device, card)
    k1_times.update(ssd_fast_k1)
    torch.cuda.empty_cache()
    paths["ssd_train"] = ssd_train(device, card)
    paths["ssd_eval"] = ssd_eval(device, card)
    paths["fast_predict"] = fast_predict_phase(device)
    torch.cuda.empty_cache()
    check_int8_parity(device)

    rpn_ms, rpn_plain_ms, rpn_bound_ms, rpn_bound_by = k1_times[(8, 12000)]
    k2_shapes = [*k2_backbones, *(k2 for k2, _ in pretrained.values())]
    k3_shapes = [k3 for _, k3 in pretrained.values()]
    k3_ms, k3_plain_ms, k3_bound_ms, k3_bound_by = k3_times["bfloat16"]
    def by_path(kernel):
        # Only the paths whose run counted this kernel's launches.
        return {name: counts[kernel] for name, counts in paths.items()
                if kernel in counts}

    print(json.dumps({"kernels": [
        {"name": "nms_alive", "route": "cuda",
         "source": "luminoth_tpu_torch/csrc/nms.cu",
         "replaces": "luminoth_tpu/ops/pallas/nms_kernel.py:181",
         "launches": sum(by_path("k1").values()),
         "launches_by_path": by_path("k1"),
         "max_abs_err": k1_err, "ms": rpn_ms, "plain_ms": rpn_plain_ms,
         "bound_ms": rpn_bound_ms, "bound_by": rpn_bound_by,
         "library_ms": None,
         "shapes": [{"groups": key[0], "candidates": key[1],
                     "on": key[2] if len(key) > 2 else "random groups",
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}
                    for key, (ms, plain_ms, bound_ms, bound_by)
                    in k1_times.items()]},
        {"name": "roi_crop_pool", "route": "cuda",
         "source": "luminoth_tpu_torch/csrc/roi_align.cu",
         "replaces": "luminoth_tpu/ops/pallas/roi_align_kernel.py:351",
         "launches": sum(by_path("k2").values()),
         "launches_by_path": by_path("k2"),
         "max_abs_err": max([k2_err, fast_k2["max_abs_err"]]
                            + [x["max_abs_err"] for x in k2_shapes]), **k2,
         "shapes": [{"rois": K2_SHAPE[1], "channels": K2_SHAPE[4],
                     "on": "random boxes", "max_abs_err": k2_err, **k2},
                    fast_k2, *k2_shapes]},
        {"name": "roi_crop_pool_backward", "route": "cuda",
         "source": "luminoth_tpu_torch/csrc/roi_align.cu",
         "replaces": "luminoth_tpu/ops/pallas/roi_align_kernel.py:189",
         "launches": sum(by_path("k3").values()),
         "launches_by_path": by_path("k3"),
         "max_abs_err": max([k3_err] + [x["max_abs_err"] for x in k3_shapes]),
         "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound_ms, "bound_by": k3_bound_by,
         "library_ms": None,
         "shapes": [{"rois": K3_SHAPE[1], "channels": K3_SHAPE[4],
                     "on": "random boxes", "max_abs_err": k3_err,
                     "ms": k3_ms, "plain_ms": k3_plain_ms,
                     "bound_ms": k3_bound_ms, "bound_by": k3_bound_by},
                    *k3_shapes]},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
