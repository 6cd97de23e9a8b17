"""ROI crop-and-resize with bilinear sampling (TF semantics) + 2x2 max-pool.

Counterpart of ``luminoth_tpu/ops/roi_align.py``. Boxes are normalized
``(y1, x1, y2, x2)`` like TF's op: sample positions are
``y1·(H−1) + i·(y2−y1)·(H−1)/(S−1)`` and samples outside the map are 0.

Square crops with the fused pool go through :class:`RoiCropPool`: kernel
K2 (``csrc/roi_align.cu``) forward and kernel K3 backward for CUDA tensors,
:func:`roi_crop_pool_reference` and :func:`roi_crop_pool_backward_reference`
for CPU tensors. Rectangular crops, and crops without the pool, take the
separable einsum formulation (autograd through it) on every device, as they
take the XLA path in the JAX package. No path differentiates the boxes.
"""

import ctypes

import numpy as np
import torch

from luminoth_tpu_torch import _build
from luminoth_tpu_torch.ops.dispatch import use_kernel

# Kernels K2 and K3 stage up to 2S x 2S taps of 16 bytes in shared memory.
MAX_STAGED_CROP = 28


def _sample_coords(lo, hi, size, image_dim):
    """TF crop_and_resize sampling positions along one axis. (..., S)."""
    lo = lo[..., None]
    hi = hi[..., None]
    if size > 1:
        # Divided on the host: CUDA divides by a scalar as a multiply by its
        # reciprocal, which is not the correctly rounded quotient the JAX
        # version and kernel K2 use.
        steps = torch.from_numpy(
            np.arange(size, dtype=np.float32) / np.float32(size - 1)
        ).to(lo.device)
        return lo * (image_dim - 1) + steps * (hi - lo) * (image_dim - 1)
    return (0.5 * (lo + hi) * (image_dim - 1)).expand(lo.shape[:-1] + (1,))


def _interp_matrix(coords, dim):
    """(..., S) float coords → (..., S, dim) bilinear tap-weight matrix."""
    in_bounds = (coords >= 0) & (coords <= dim - 1)
    lo = torch.clamp(torch.floor(coords), 0, dim - 1)
    hi = torch.clamp(lo + 1, 0, dim - 1)
    frac = coords - lo
    lo_oh = torch.nn.functional.one_hot(lo.long(), dim).float()
    hi_oh = torch.nn.functional.one_hot(hi.long(), dim).float()
    weights = (1.0 - frac)[..., None] * lo_oh + frac[..., None] * hi_oh
    return weights * in_bounds[..., None]


def _pair(crop_size):
    """Normalize an int-or-(height, width) crop size to ``(sy, sx)``."""
    if isinstance(crop_size, (tuple, list)):
        return int(crop_size[0]), int(crop_size[1])
    return int(crop_size), int(crop_size)


def interp_weights(boxes, h, w, crop_size):
    """Interpolation matrices ``(Wy (..., Sy, H), Wx (..., Sx, W))``."""
    sy, sx = _pair(crop_size)
    y1, x1, y2, x2 = boxes.unbind(-1)
    wy = _interp_matrix(_sample_coords(y1, y2, sy, h), h)
    wx = _interp_matrix(_sample_coords(x1, x2, sx, w), w)
    return wy, wx


def crop_and_resize(feature_map, boxes, crop_size, chunk_size=512):
    """Crop normalized boxes from a feature map with bilinear resampling.

    Args:
        feature_map: (H, W, C) feature map.
        boxes: (R, 4) normalized ``(y1, x1, y2, x2)`` boxes.
        crop_size: output side S, or an ``(Sy, Sx)`` pair.
        chunk_size: ROIs per chunk (bounds the rows intermediate).

    Returns:
        (R, Sy, Sx, C) crops in the feature map's dtype. Each stage sums in
        float32 where the device does (bf16 matmuls accumulate in float32)
        and rounds to the feature map's dtype, as the JAX version does.
    """
    boxes = boxes.float()
    h, w, _ = feature_map.shape
    dtype = feature_map.dtype
    crops = []
    for start in range(0, boxes.shape[0], chunk_size):
        wy, wx = interp_weights(boxes[start:start + chunk_size], h, w,
                                crop_size)
        rows = torch.einsum("rsh,hwc->rswc", wy.to(dtype), feature_map)
        crops.append(torch.einsum("rtw,rswc->rstc", wx.to(dtype), rows))
    if not crops:
        sy, sx = _pair(crop_size)
        return feature_map.new_zeros((0, sy, sx, feature_map.shape[-1]))
    return torch.cat(crops)


def _max_pool_2x2(crops):
    """(R, Sy, Sx, C) → (R, Sy/2, Sx/2, C) 2x2/2 max-pool."""
    r, sy, sx, c = crops.shape
    return crops.reshape(r, sy // 2, 2, sx // 2, 2, c).amax(dim=(2, 4))


def roi_crop_pool_reference(feature_maps, boxes, crop_size):
    """Plain PyTorch version of kernel K2.

    Args:
        feature_maps: (B, H, W, C) NHWC maps.
        boxes: (B, R, 4) normalized ``(y1, x1, y2, x2)`` boxes.
        crop_size: even square side S.

    Returns:
        (B, R, S/2, S/2, C) pooled crops in the maps' dtype: the separable
        einsum of :func:`crop_and_resize`, chunked over ROIs, then the
        2x2/2 max-pool.
    """
    return torch.stack([
        _max_pool_2x2(crop_and_resize(fm, image_boxes, crop_size))
        for fm, image_boxes in zip(feature_maps, boxes)
    ])


def roi_crop_pool_backward_reference(feature_maps, boxes, grad, crop_size,
                                     chunk_size=64):
    """Plain PyTorch version of kernel K3: d_feature_maps of the crop+pool.

    Args:
        feature_maps: (B, H, W, C) NHWC maps (float32 or bfloat16).
        boxes: (B, R, 4) normalized ``(y1, x1, y2, x2)`` boxes.
        grad: (B, R, S/2, S/2, C) cotangent of the pooled crops.
        crop_size: even square side S.
        chunk_size: ROIs per chunk (bounds the recomputed crop).

    Returns:
        float32 (B, H, W, C). The pre-pool crop is recomputed in float32
        from the map's values, as kernel K2 sums it (one rounding, not the
        TPU kernel's bf16 stage-1 cast), each pooled cotangent goes to its
        window's maxima split evenly over ties (``is_max / ties``), then
        through Wxᵀ and Wyᵀ, accumulated in float32, as
        ``_roi_align_bwd_xla`` does.
    """
    s = int(crop_size)
    p = s // 2
    b, h, w, c = feature_maps.shape
    d_fm = torch.zeros((b, h, w, c), dtype=torch.float32,
                       device=feature_maps.device)
    boxes = boxes.float()
    for i in range(b):
        fm = feature_maps[i].float()
        for start in range(0, boxes.shape[1], chunk_size):
            wy, wx = interp_weights(boxes[i, start:start + chunk_size], h, w,
                                    s)
            g = grad[i, start:start + chunk_size].float()
            r = g.shape[0]
            rows = torch.einsum("rsh,hwc->rswc", wy, fm)
            crop = torch.einsum("rtw,rswc->rstc", wx, rows)
            win = crop.reshape(r, p, 2, p, 2, c)
            is_max = (win == win.amax(dim=(2, 4), keepdim=True)).float()
            ties = is_max.sum(dim=(2, 4), keepdim=True)
            g_crop = (is_max / ties * g.reshape(r, p, 1, p, 1, c)).reshape(
                r, s, s, c)
            d_rows = torch.einsum("rtw,rstc->rswc", wx, g_crop)
            d_fm[i] += torch.einsum("rsh,rswc->hwc", wy, d_rows)
    return d_fm


def load_library():
    """Build (at first use) and load ``csrc/roi_align.cu``."""
    return _build.load("roi_align", _configure_roi)


def _configure_roi(lib):
    for fn in (lib.lumi_roi_crop_pool_f32, lib.lumi_roi_crop_pool_bf16):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    for fn in (lib.lumi_roi_crop_pool_bwd_f32,
               lib.lumi_roi_crop_pool_bwd_bf16):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    lib.lumi_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lumi_cuda_error_string.restype = ctypes.c_char_p


def _check_kernel_args(what, feature_maps, boxes, crop_size, *others):
    """Validate the tensors of a K2/K3 launch; returns the crop side."""
    tensors = (feature_maps, boxes) + others
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{what} takes CUDA tensors")
    if any(t.device != feature_maps.device for t in tensors):
        raise ValueError(f"{what}: tensors lie on different devices")
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if feature_maps.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"feature maps must be float32 or bfloat16, got "
            f"{feature_maps.dtype}"
        )
    if feature_maps.dim() != 4 or boxes.dim() != 3 or boxes.shape[-1] != 4 or (
        boxes.shape[0] != feature_maps.shape[0]
    ):
        raise ValueError(
            f"expected maps (B, H, W, C) and boxes (B, R, 4), got "
            f"{tuple(feature_maps.shape)} and {tuple(boxes.shape)}"
        )
    s = int(crop_size)
    if s < 2 or s > MAX_STAGED_CROP or s % 2:
        raise ValueError(
            f"{what} takes an even crop_size in [2, {MAX_STAGED_CROP}] (2S "
            f"x 2S taps are staged in shared memory), got {s}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} takes contiguous tensors")
    # The kernels move 16 bytes of channels at a time.
    width = 16 // feature_maps.element_size()
    if feature_maps.shape[-1] % width:
        raise ValueError(
            f"{what} takes a channel count that is a multiple of {width} "
            f"for {feature_maps.dtype} maps, got {feature_maps.shape[-1]}"
        )
    maps_and_cotangents = (feature_maps,) + others
    if any(t.data_ptr() % 16 for t in maps_and_cotangents):
        raise ValueError(f"{what} takes 16-byte aligned maps and cotangents")
    return s


def roi_crop_pool_cuda(feature_maps, boxes, crop_size):
    """Kernel K2: fused bilinear crop + 2x2 max-pool, on the GPU.

    Same arguments and result as :func:`roi_crop_pool_reference`. float32
    maps match it to float32 rounding; bf16 maps are summed in float32 and
    rounded once, so they are within one bf16 rounding (2^-8 relative) of
    the float32 result on the same inputs.

    The kernel moves 16 bytes of channels at a time and stages an ROI's
    whole footprint (at most 2S x 2S taps) in shared memory, so it takes
    a channel count that is a multiple of 8 (bf16) or 4 (float32), crops of
    at most 28, and 16-byte aligned maps; it raises on anything else.
    """
    s = _check_kernel_args("roi_crop_pool_cuda", feature_maps, boxes,
                           crop_size)
    lib = load_library()
    entry = {
        torch.float32: lib.lumi_roi_crop_pool_f32,
        torch.bfloat16: lib.lumi_roi_crop_pool_bf16,
    }[feature_maps.dtype]
    b, h, w, c = feature_maps.shape
    r = boxes.shape[1]
    out = torch.empty((b, r, s // 2, s // 2, c), dtype=feature_maps.dtype,
                      device=feature_maps.device)
    with torch.cuda.device(feature_maps.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = entry(
            feature_maps.data_ptr(), boxes.data_ptr(), out.data_ptr(),
            b, r, h, w, c, s, stream,
        )
    _build.check_status(lib, status, "roi_crop_pool_cuda")
    roi_crop_pool_cuda.launches += 1
    return out


roi_crop_pool_cuda.launches = 0


def roi_crop_pool_backward_cuda(feature_maps, boxes, grad, crop_size):
    """Kernel K3: d_feature_maps of the fused crop + 2x2 max-pool, on the GPU.

    Same arguments and result as :func:`roi_crop_pool_backward_reference`
    (``grad`` in the maps' dtype). The window maxima are found on samples
    recomputed with kernel K2's float32 arithmetic, so the routing follows
    K2's output; float32 atomics accumulate in an order that changes from
    run to run.

    It stages an ROI's footprint in shared memory as K2 does and sums each
    footprint place's gradient on chip before one atomic add, so it takes
    what K2 takes: a channel count that is a multiple of 8 (bf16) or 4
    (float32), crops of at most 28, and 16-byte aligned maps and
    cotangents; it raises on anything else.
    """
    s = _check_kernel_args("roi_crop_pool_backward_cuda", feature_maps,
                           boxes, crop_size, grad)
    b, h, w, c = feature_maps.shape
    r = boxes.shape[1]
    if grad.dtype != feature_maps.dtype or tuple(grad.shape) != (
        b, r, s // 2, s // 2, c
    ):
        raise ValueError(
            f"grad must be {feature_maps.dtype} of shape "
            f"{(b, r, s // 2, s // 2, c)}, got {grad.dtype} "
            f"{tuple(grad.shape)}"
        )
    lib = load_library()
    entry = {
        torch.float32: lib.lumi_roi_crop_pool_bwd_f32,
        torch.bfloat16: lib.lumi_roi_crop_pool_bwd_bf16,
    }[feature_maps.dtype]
    d_fm = torch.zeros((b, h, w, c), dtype=torch.float32,
                       device=feature_maps.device)
    with torch.cuda.device(feature_maps.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = entry(
            feature_maps.data_ptr(), boxes.data_ptr(), grad.data_ptr(),
            d_fm.data_ptr(), b, r, h, w, c, s, stream,
        )
    _build.check_status(lib, status, "roi_crop_pool_backward_cuda")
    roi_crop_pool_backward_cuda.launches += 1
    return d_fm


roi_crop_pool_backward_cuda.launches = 0


class RoiCropPool(torch.autograd.Function):
    """Square crop + 2x2 max-pool with its hand-written backward.

    CUDA maps take kernels K2 (forward) and K3 (backward), CPU maps their
    plain versions, so both devices run the same autograd wiring. The boxes
    get no gradient (the JAX VJP returns zero cotangents for them), and
    d_feature_maps comes back in the maps' dtype, as ``_roi_align_bwd``
    casts it.
    """

    @staticmethod
    def forward(ctx, feature_maps, boxes, crop_size):
        ctx.crop_size = crop_size
        ctx.save_for_backward(feature_maps, boxes)
        if use_kernel(feature_maps):
            return roi_crop_pool_cuda(
                feature_maps.contiguous(), boxes.contiguous(), crop_size
            )
        return roi_crop_pool_reference(feature_maps, boxes, crop_size)

    @staticmethod
    def backward(ctx, grad):
        feature_maps, boxes = ctx.saved_tensors
        if use_kernel(feature_maps):
            d_fm = roi_crop_pool_backward_cuda(
                feature_maps.contiguous(), boxes.contiguous(),
                grad.to(feature_maps.dtype).contiguous(), ctx.crop_size,
            )
        else:
            d_fm = roi_crop_pool_backward_reference(
                feature_maps, boxes, grad, ctx.crop_size
            )
        return d_fm.to(feature_maps.dtype), None, None


def roi_crop_pool_batch(feature_maps, rois, im_shape, crop_size=14,
                        pool=True):
    """Crop and pool (B, R, 4) xyxy rois from (B, H, W, C) NHWC maps.

    ``rois`` live in an ``im_shape`` (height, width) frame: the padded
    canvas, for the detector. Returns (B, R, Sy/2, Sx/2, C) when ``pool``
    else (B, R, Sy, Sx, C).
    """
    sy, sx = _pair(crop_size)
    # A tensor divisor: CUDA divides by a host scalar as a multiply by its
    # reciprocal, one ulp off the quotient the JAX version computes.
    frame = torch.tensor([im_shape[1], im_shape[0]] * 2, dtype=torch.float32,
                         device=rois.device)
    # No gradient reaches the boxes on any path, as in the JAX op.
    x1, y1, x2, y2 = (rois.detach().float() / frame).unbind(-1)
    boxes = torch.stack([y1, x1, y2, x2], dim=-1)

    if sy == sx and pool:
        return RoiCropPool.apply(feature_maps, boxes, sy)

    crops = torch.stack([
        crop_and_resize(fm, image_boxes, (sy, sx))
        for fm, image_boxes in zip(feature_maps, boxes)
    ])
    if not pool:
        return crops
    b, r = crops.shape[:2]
    return _max_pool_2x2(crops.flatten(0, 1)).reshape(
        (b, r) + (sy // 2, sx // 2, crops.shape[-1])
    )
