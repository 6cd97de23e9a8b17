#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

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
backward kernel against its plain version on a train step's own tensors.
Every phase prints one line; any failure exits non-zero. The last three
lines are the kernels' JSON record, the card's name and power limit, and
``{"ok": true, ...}``.

Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result.
"""

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
BATCH = 8
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
        want = first_alive(nms.nms_alive_reference(boxes, valid, thr), keep)
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
        times[(g, n)] = (ms, plain_ms)
        phase("k1", groups=g, candidates=n, threshold=thr, keep=keep,
              equal=True, survivors=int(got.ge(0).sum()),
              kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
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
    phase("k2", shape="x".join(map(str, K2_SHAPE)),
          f32_max_abs_err=err_f32, bf16_max_abs_err=err_bf16,
          bf16_kernel_ms=f"{ms:.4f}", bf16_plain_ms=f"{plain_ms:.4f}",
          f32_kernel_ms=f"{ms32:.4f}", f32_plain_ms=f"{plain_ms32:.4f}")
    return err_bf16, ms, plain_ms


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


def check_k3(device):
    import numpy as np
    import torch
    from luminoth_tpu_torch.ops import roi_align

    b, r, h, w, c, s = K3_SHAPE
    rng = np.random.default_rng(SEED + 4)
    g = torch.from_numpy(
        rng.standard_normal((b, r, s // 2, s // 2, c)).astype(np.float32)
    ).to(device)
    fm_cells, boxes_cells, g_cells = k3_on_cell_inputs(device)
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
        times[name] = (ms, plain_ms)
        phase("k3", shape="x".join(map(str, K3_SHAPE)), dtype=name,
              a_max_abs_err=a["max_abs_err"],
              a_identity_rel_err=a["identity_rel_err"],
              b_max_abs_err=bc["max_abs_err"],
              b_near_tie_windows=bc["near_tie_windows"],
              b_excluded_share=bc["excluded_share"],
              c_identity_rel_err=bc["identity_rel_err"],
              kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
              k2_forward_ms=f"{k2_ms:.4f}")
    return worst, times


def serve_config(architecture, classes, dtype, canvas, budgets=None):
    """The config a user would write, as YAML under ``build/``."""
    import yaml

    model = {
        "type": "fasterrcnn",
        "compute_dtype": dtype,
        "network": {"num_classes": classes},
        "base_network": {"architecture": architecture},
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
    path = os.path.join(BUILD, f"{architecture}_{dtype}_{canvas[0]}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def check_small_parity(device):
    """The served path (kernels) against the plain versions, f32, small."""
    import numpy as np
    import torch
    from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN
    from luminoth_tpu_torch.utils.config import get_config
    from luminoth_tpu_torch.utils.weights import (
        init_variables,
        load_flax_variables,
    )

    config = get_config(serve_config(
        "resnet_v1_101", 80, "float32", (160, 224),
        budgets={"rpn": {"pre_nms_top_n": 400, "post_nms_top_n": 50}},
    ))
    variables = init_variables(config, SEED)
    images = torch.from_numpy(
        (np.random.default_rng(SEED).random((2, 160, 224, 3)) * 255)
        .astype(np.float32)
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
            f"served path disagrees with the plain versions: valid/labels "
            f"equal={same}, box max err {box_err} px"
        )
    phase("parity", model="resnet_v1_101", dtype="float32",
          images="2x160x224", detections=int(valid.sum()),
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
    import torch
    from luminoth_tpu_torch.ops import nms, roi_align

    captured = {"nms": [], "roi": []}
    nms_kernel, roi_kernel = nms.nms_alive_cuda, roi_align.roi_crop_pool_cuda

    def nms_capture(boxes, valid, thr, keep=0):
        captured["nms"].append((boxes.clone(), valid.clone(), thr, keep))
        return nms_kernel(boxes, valid, thr, keep)

    def roi_capture(fm, boxes, s):
        captured["roi"].append((fm.clone(), boxes.clone(), s))
        return roi_kernel(fm, boxes, s)

    # The wrappers count their launches on the name they are bound to.
    nms_capture.launches = roi_capture.launches = 0
    nms.nms_alive_cuda, roi_align.roi_crop_pool_cuda = nms_capture, roi_capture
    try:
        rng = np.random.default_rng(SEED + 1)
        detector.predict([rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
                          for _ in range(BATCH)])
    finally:
        nms.nms_alive_cuda, roi_align.roi_crop_pool_cuda = (
            nms_kernel, roi_kernel)

    for boxes, valid, thr, keep in captured["nms"]:
        got = first_alive(nms_kernel(boxes, valid, thr, keep), keep)
        want = first_alive(nms.nms_alive_reference(boxes, valid, thr), keep)
        if not torch.equal(got, want):
            raise AssertionError(
                f"K1 disagrees on served tensors {tuple(boxes.shape)}")
        phase("k1-served", groups=boxes.shape[0], candidates=boxes.shape[1],
              threshold=thr, keep=keep, equal=True,
              survivors=int(got.ge(0).sum()))
    for fm, boxes, s in captured["roi"]:
        got = roi_kernel(fm, boxes, s).float()
        want = roi_align.roi_crop_pool_reference(fm.float(), boxes, s)
        err = float((got - want).abs().max())
        if not bool(((got - want).abs()
                     <= K2_BF16_RTOL * want.abs() + K2_BF16_ATOL).all()):
            raise AssertionError(f"K2 disagrees on served tensors: {err}")
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


def train(device, card):
    """Full width through ``train.run``: R101, 80 classes, bf16, batch 8,
    608x800; then a second ``run`` resumes from the checkpoint."""
    import shutil

    import torch
    from luminoth_tpu_torch import train as trainer
    from luminoth_tpu_torch.ops import nms, roi_align
    from luminoth_tpu_torch.utils.config import get_config
    from luminoth_tpu_torch.utils.synthetic import write_synthetic_records

    jobs = os.path.join(BUILD, "jobs")
    shutil.rmtree(jobs, ignore_errors=True)
    data, _ = write_synthetic_records(os.path.join(BUILD, "data"),
                                      TRAIN_IMAGES, 80, SEED + 6)
    config = get_config(train_config(
        os.path.join(BUILD, "train.yml"), 80, "bfloat16", CANVAS,
        {"train": {"job_dir": jobs, "run_name": "smoke"},
         "dataset": {"dir": data}},
    ))
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
    bwd = roi_align.roi_crop_pool_backward_cuda

    def bwd_capture(fm, boxes, grad, s):
        captured[:] = [(fm.clone(), boxes.clone(), grad.clone(), s)]
        return bwd(fm, boxes, grad, s)

    # The wrappers count their launches on the name they are bound to.
    kernels["k3"] = bwd_capture
    for kernel in kernels.values():
        kernel.launches = 0
    roi_align.roi_crop_pool_backward_cuda = bwd_capture
    try:
        resumed = trainer.run(config, max_steps=TRAIN_STEPS + RESUME_STEPS,
                              device=device)
    finally:
        roi_align.roi_crop_pool_backward_cuda = bwd
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
    fm, boxes, grad, s = captured
    g_max = float(grad.abs().max())
    if not 0 < g_max < math.inf:
        raise AssertionError(f"train-step ROI cotangents of max {g_max}")
    scale = 2.0 ** -math.floor(math.log2(g_max))
    out = hold_k3(fm, boxes, grad * scale, s)
    phase("k3-trained", shape="x".join(map(str, fm.shape)),
          rois=boxes.shape[1], dtype=str(fm.dtype).split(".")[-1],
          map_max=float(fm.abs().max()), cotangent_scale=scale, **out)
    return out["max_abs_err"]


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
    k2_err, k2_ms, k2_plain_ms = check_k2(device)
    torch.cuda.empty_cache()
    k3_err, k3_times = check_k3(device)
    torch.cuda.empty_cache()
    check_small_parity(device)
    served, detector = serve(device, card)
    recheck_on_served_tensors(detector, device)
    del detector
    torch.cuda.empty_cache()
    check_train_parity(device)
    trained, captured = train(device, card)
    k3_err = max(k3_err, recheck_k3_on_trained_tensors(captured))

    rpn_ms, rpn_plain_ms = k1_times[(8, 12000)]
    k3_ms, k3_plain_ms = k3_times["bfloat16"]
    print(json.dumps({"kernels": [
        {"name": "nms_alive", "route": "cuda",
         "source": "luminoth_tpu_torch/csrc/nms.cu",
         "replaces": "luminoth_tpu/ops/pallas/nms_kernel.py:181",
         "launches": served["k1"] + trained["k1"],
         "launches_by_path": {"serve": served["k1"], "train": trained["k1"]},
         "max_abs_err": k1_err, "ms": rpn_ms, "plain_ms": rpn_plain_ms},
        {"name": "roi_crop_pool", "route": "cuda",
         "source": "luminoth_tpu_torch/csrc/roi_align.cu",
         "replaces": "luminoth_tpu/ops/pallas/roi_align_kernel.py:351",
         "launches": served["k2"] + trained["k2"],
         "launches_by_path": {"serve": served["k2"], "train": trained["k2"]},
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": "roi_crop_pool_backward", "route": "cuda",
         "source": "luminoth_tpu_torch/csrc/roi_align.cu",
         "replaces": "luminoth_tpu/ops/pallas/roi_align_kernel.py:189",
         "launches": trained["k3"],
         "launches_by_path": {"serve": 0, "train": trained["k3"]},
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
