#!/usr/bin/env python3
"""Time kernels K1 (grouped NMS), K2 (ROI crop+pool) and K3 (its backward)
against an earlier version of their sources, in turns, on one GPU.

    git show <commit>:luminoth_tpu_torch/csrc/nms.cu > build/old_csrc/nms.cu
    git show <commit>:luminoth_tpu_torch/csrc/roi_align.cu \\
        > build/old_csrc/roi_align.cu
    python scripts/compare_torch_kernels.py --old build/old_csrc [--out F]

The earlier sources are built with the same ``nvcc`` flags as the port's
(into ``build/``) and called through the current C interface (K1's with
its scratch buffer; sources from before that interface are not taken).
At every K1 shape of
``chip_smoke.py``, at K2's serve shape (8 x 2000 ROIs) and train shape
(8 x 256 ROIs), and at K3's train shape on three inputs (``chip_smoke``'s
random boxes and on-cell boxes, and the map, boxes and cotangents of a
train step of ``chip_smoke``'s [train] configuration), float32 and bf16,
it

* checks K1's first ``keep`` survivors of old and new against each other
  and against the plain version, that new K2's output equals the old
  one's bit for bit, and that new K3's equals the old one's on the
  on-cell inputs (every sum exact) and is within check (b)'s tolerance
  of it elsewhere (the train step's cotangents scaled to unit size);
* times old, new, new, old with CUDA events, and reports each version's
  mean of its two turns, its share of the bound (``chip_smoke.bound``) and
  the speed-up; for K2 and K3 also the plain version's time, and for K2
  the library yardstick's (``chip_smoke.k2_library_ms``).

It prints the card's name and power limit and one JSON line, and writes
the JSON to ``--out``. Needs a CUDA device and ``nvcc``.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from luminoth_tpu_torch import _build  # noqa: E402
from luminoth_tpu_torch.ops import nms, roi_align  # noqa: E402

K2_SHAPES = {"serve": 2000, "train": 256}  # ROIs per image, as in chip_smoke


def build_old(old_dir):
    """Build ``nms.cu`` and ``roi_align.cu`` of ``old_dir``; return the
    two libraries with their ctypes signatures declared."""
    out_dir = os.path.join(ROOT, "build", "compare_old")
    os.makedirs(out_dir, exist_ok=True)

    def compile_one(name):
        path = os.path.join(out_dir, f"lib{name}_old.so")
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", path,
                        os.path.join(old_dir, f"{name}.cu")],
                       check=True, capture_output=True, text=True)
        return ctypes.CDLL(path)

    with ThreadPoolExecutor(2) as pool:
        old_nms, old_roi = pool.map(compile_one, ("nms", "roi_align"))
    nms._configure_nms(old_nms)
    for fn in (old_roi.lumi_roi_crop_pool_f32, old_roi.lumi_roi_crop_pool_bf16):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    declare_k3(old_roi)
    return old_nms, old_roi


def declare_k3(lib):
    """Declare the ctypes signature of a roi_align library's K3 entries."""
    for fn in (lib.lumi_roi_crop_pool_bwd_f32,
               lib.lumi_roi_crop_pool_bwd_bf16):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int


def stream():
    return torch.cuda.current_stream().cuda_stream


def old_k1(lib, boxes, valid, thr, keep):
    g, n = valid.shape
    alive = torch.empty((g, n), dtype=torch.bool, device=boxes.device)
    nbytes = lib.lumi_nms_scratch_bytes(g, n, keep)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=boxes.device)
               if nbytes else None)
    status = lib.lumi_nms_alive(
        boxes.data_ptr(), valid.data_ptr(), alive.data_ptr(), g, n, thr, keep,
        None if scratch is None else scratch.data_ptr(), stream())
    if status:
        raise RuntimeError(f"old K1: CUDA error {status}")
    return alive


def old_k2(lib, fm, boxes, s):
    b, h, w, c = fm.shape
    r = boxes.shape[1]
    out = torch.empty((b, r, s // 2, s // 2, c), dtype=fm.dtype,
                      device=fm.device)
    entry = (lib.lumi_roi_crop_pool_bf16 if fm.dtype == torch.bfloat16
             else lib.lumi_roi_crop_pool_f32)
    status = entry(fm.data_ptr(), boxes.data_ptr(), out.data_ptr(), b, r, h,
                   w, c, s, stream())
    if status:
        raise RuntimeError(f"old K2: CUDA error {status}")
    return out


def lib_k3(lib, fm, boxes, grad, s):
    """K3 of the library ``lib`` (its C interface, as the wrapper calls it)."""
    b, h, w, c = fm.shape
    d_fm = torch.zeros((b, h, w, c), dtype=torch.float32, device=fm.device)
    entry = (lib.lumi_roi_crop_pool_bwd_bf16 if fm.dtype == torch.bfloat16
             else lib.lumi_roi_crop_pool_bwd_f32)
    status = entry(fm.data_ptr(), boxes.data_ptr(), grad.data_ptr(),
                   d_fm.data_ptr(), b, boxes.shape[1], h, w, c, s, stream())
    if status:
        raise RuntimeError(f"K3 of {lib._name}: CUDA error {status}")
    return d_fm


def k3_input_sets(device):
    """{name: (fm, boxes, grad, s)} in float32: chip_smoke's random and
    on-cell inputs and a train step's own (cotangents scaled to unit
    size), at K3's train shape."""
    s = smoke.K3_SHAPE[-1]
    fm, boxes, grad, s_trained = smoke.trained_k3_inputs(device)
    grad = grad * smoke.unit_scale(grad)
    return {
        "random": (*smoke.k3_random_inputs(device), s),
        "on-cell": (*smoke.k3_on_cell_inputs(device), s),
        "train-step": (fm.float(), boxes, grad.float(), s_trained),
    }


def within_k3_tol(got, want, exact):
    if exact:
        return torch.equal(got, want)
    tol = smoke.K3_TOL
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


def in_turns(old, new, iters, warmup):
    """Mean ms of old and new, timed old, new, new, old."""
    times = {"old": [], "new": []}
    for name in ("old", "new", "new", "old"):
        fn = old if name == "old" else new
        times[name].append(smoke.cuda_ms(fn, iters, warmup=warmup))
    return {k: sum(v) / len(v) for k, v in times.items()}, times


def record(rows, kernel, shape, bound_ms, bound_by, turns, **extra):
    means, times = turns
    rows.append({
        "kernel": kernel, "shape": shape, **extra,
        "old_ms": means["old"], "new_ms": means["new"],
        "old_turns_ms": times["old"], "new_turns_ms": times["new"],
        "speedup": means["old"] / means["new"],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "old_share_of_bound": bound_ms / means["old"],
        "new_share_of_bound": bound_ms / means["new"],
    })
    print(json.dumps(rows[-1]), flush=True)


def compare_k1(old_nms, device, rows):
    for g, n, thr, keep in smoke.K1_SHAPES:
        boxes, valid = smoke.random_sorted_groups(g, n, smoke.SEED + n,
                                                  device)
        plain = nms.nms_alive_reference(boxes, valid, thr)
        want = smoke.first_alive(plain, keep)
        old = smoke.first_alive(old_k1(old_nms, boxes, valid, thr, keep),
                                keep)
        new = smoke.first_alive(nms.nms_alive_cuda(boxes, valid, thr, keep),
                                keep)
        if not (torch.equal(old, want) and torch.equal(new, want)):
            raise AssertionError(f"K1 old/new disagree at G={g} N={n}")
        bound_ms, bound_by = smoke.k1_bound(boxes, valid, plain, keep)
        record(rows, "nms_alive", f"G={g} N={n} thr={thr} keep={keep}",
               bound_ms, bound_by, in_turns(
                   lambda: old_k1(old_nms, boxes, valid, thr, keep),
                   lambda: nms.nms_alive_cuda(boxes, valid, thr, keep),
                   20, 3),
               equal_to_plain=True)


def compare_k2(old_roi, device, rows):
    s = smoke.K2_SHAPE[-1]
    fm32, boxes_all = smoke.k2_inputs(device)
    for dtype in (torch.bfloat16, torch.float32):
        fm = fm32.to(dtype)
        for path, r in K2_SHAPES.items():
            boxes = boxes_all[:, :r].contiguous()
            old = old_k2(old_roi, fm, boxes, s)
            new = roi_align.roi_crop_pool_cuda(fm, boxes, s)
            bitwise = torch.equal(old.view(torch.int16 if dtype ==
                                           torch.bfloat16 else torch.int32),
                                  new.view(torch.int16 if dtype ==
                                           torch.bfloat16 else torch.int32))
            if not bitwise:
                raise AssertionError(
                    f"new K2 differs from the old one ({path}, {dtype}): "
                    f"{int((old != new).sum())} elements")
            del old, new
            bound_ms, bound_by = smoke.k2_bound(fm, boxes, s)
            turns = in_turns(
                lambda: old_k2(old_roi, fm, boxes, s),
                lambda: roi_align.roi_crop_pool_cuda(fm, boxes, s), 10, 2)
            plain_ms = smoke.cuda_ms(
                lambda: roi_align.roi_crop_pool_reference(fm, boxes, s), 2)
            record(rows, "roi_crop_pool",
                   f"{path} B=8 R={r} 38x50x1024 S={s}", bound_ms, bound_by,
                   turns, dtype=str(dtype).split(".")[-1], bitwise_equal=True,
                   plain_ms=plain_ms,
                   library_ms=smoke.k2_library_ms(fm, boxes, s))


def compare_k3(old_roi, device, rows):
    for name, (fm32, boxes, g32, s) in k3_input_sets(device).items():
        for dtype in (torch.bfloat16, torch.float32):
            fm, grad = fm32.to(dtype), g32.to(dtype)
            old = lib_k3(old_roi, fm, boxes, grad, s)
            new = roi_align.roi_crop_pool_backward_cuda(fm, boxes, grad, s)
            exact = name == "on-cell"
            if not within_k3_tol(new, old, exact):
                raise AssertionError(
                    f"new K3 differs from the old one ({name}, {dtype}): max "
                    f"{float((new - old).abs().max())}")
            err = float((new - old).abs().max())
            del old, new
            if exact:
                continue
            bound_ms, bound_by = smoke.k3_bound(fm, boxes, grad)
            turns = in_turns(
                lambda: lib_k3(old_roi, fm, boxes, grad, s),
                lambda: roi_align.roi_crop_pool_backward_cuda(fm, boxes, grad,
                                                              s),
                10, 2)
            plain_ms = smoke.cuda_ms(
                lambda: roi_align.roi_crop_pool_backward_reference(
                    fm, boxes, grad, s), 2)
            record(rows, "roi_crop_pool_backward",
                   f"{name} B={fm.shape[0]} R={boxes.shape[1]} "
                   f"{'x'.join(map(str, fm.shape[1:]))} S={s}",
                   bound_ms, bound_by, turns,
                   dtype=str(dtype).split(".")[-1], max_abs_diff_old_new=err,
                   plain_ms=plain_ms)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old", required=True,
                        help="directory holding the earlier nms.cu and "
                             "roi_align.cu")
    parser.add_argument("--out", help="write the JSON result here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("compare_torch_kernels: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = smoke.card_line()
    print(card, flush=True)
    old_nms, old_roi = build_old(args.old)
    nms.load_library()
    roi_align.load_library()
    rows = []
    compare_k1(old_nms, device, rows)
    compare_k2(old_roi, device, rows)
    compare_k3(old_roi, device, rows)
    result = {"card": card, "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
