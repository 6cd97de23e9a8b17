#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA GPU and ``nvcc``.
It builds the port's CUDA kernels from ``luminoth_tpu_torch/csrc`` (into
``build/luminoth_tpu_torch/``), holds each kernel against its plain
PyTorch version at the serving path's shapes, checks the served model
against the plain versions on a small input, then serves requests through
``Detector`` at full width: Faster R-CNN ResNet-101 v1, 80 classes, bf16,
a 608x800 canvas, random weights from a seed. Every phase prints one line;
any failure exits non-zero. The last three lines are the kernels' JSON
record, the card's name and power limit, and ``{"ok": true, ...}``.

Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

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
BOX_ATOL = 1e-2  # px, served model vs the plain versions on a small input
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
    fm = torch.from_numpy(
        np.maximum(rng.standard_normal((b, h, w, c)), 0).astype(np.float32)
    ).to(device)
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from luminoth_tpu_torch import _build
    from luminoth_tpu_torch.ops import nms, roi_align

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

    for name, configure in (("nms", nms._configure_nms),
                            ("roi_align", roi_align._configure_roi)):
        t = time.perf_counter()
        _build.load(name, configure)
        phase("build", source=f"luminoth_tpu_torch/csrc/{name}.cu",
              library=os.path.relpath(_build.library_path(name), HERE),
              seconds=f"{time.perf_counter() - t:.1f}")

    k1_err, k1_times = check_k1(device)
    k2_err, k2_ms, k2_plain_ms = check_k2(device)
    torch.cuda.empty_cache()
    check_small_parity(device)
    launches, detector = serve(device, card)
    recheck_on_served_tensors(detector, device)

    rpn_ms, rpn_plain_ms = k1_times[(8, 12000)]
    print(json.dumps({"kernels": [
        {"name": "nms_alive", "route": "cuda",
         "source": "luminoth_tpu_torch/csrc/nms.cu",
         "replaces": "luminoth_tpu/ops/pallas/nms_kernel.py:181",
         "launches": launches["k1"], "max_abs_err": k1_err,
         "ms": rpn_ms, "plain_ms": rpn_plain_ms},
        {"name": "roi_crop_pool", "route": "cuda",
         "source": "luminoth_tpu_torch/csrc/roi_align.cu",
         "replaces": "luminoth_tpu/ops/pallas/roi_align_kernel.py:351",
         "launches": launches["k2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
