"""ROI crop-and-resize with bilinear sampling (TF semantics) + 2x2 max-pool.

Counterpart of ``luminoth_tpu/ops/roi_align.py``. Boxes are normalized
``(y1, x1, y2, x2)`` like TF's op: sample positions are
``y1·(H−1) + i·(y2−y1)·(H−1)/(S−1)`` and samples outside the map are 0.

Square crops with the fused pool go to kernel K2 (``csrc/roi_align.cu``)
for CUDA tensors and to :func:`roi_crop_pool_reference` for CPU tensors.
Rectangular crops, and crops without the pool, take the separable einsum
formulation on every device, as they take the XLA path in the JAX package.
"""

import ctypes

import numpy as np
import torch

from luminoth_tpu_torch import _build
from luminoth_tpu_torch.ops.dispatch import use_kernel


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


def _configure_roi(lib):
    for fn in (lib.lumi_roi_crop_pool_f32, lib.lumi_roi_crop_pool_bf16):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    lib.lumi_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lumi_cuda_error_string.restype = ctypes.c_char_p


def roi_crop_pool_cuda(feature_maps, boxes, crop_size):
    """Kernel K2: fused bilinear crop + 2x2 max-pool, on the GPU.

    Same arguments and result as :func:`roi_crop_pool_reference`. float32
    maps match it to float32 rounding; bf16 maps are summed in float32 and
    rounded once, so they are within one bf16 rounding (2^-8 relative) of
    the float32 result on the same inputs.
    """
    if not (feature_maps.is_cuda and boxes.is_cuda):
        raise ValueError("roi_crop_pool_cuda takes CUDA tensors")
    if feature_maps.device != boxes.device:
        raise ValueError("feature maps and boxes lie on different devices")
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if feature_maps.dim() != 4 or boxes.dim() != 3 or boxes.shape[-1] != 4 or (
        boxes.shape[0] != feature_maps.shape[0]
    ):
        raise ValueError(
            f"expected maps (B, H, W, C) and boxes (B, R, 4), got "
            f"{tuple(feature_maps.shape)} and {tuple(boxes.shape)}"
        )
    s = int(crop_size)
    if s < 2 or s > 64 or s % 2:
        raise ValueError(f"crop_size must be even and in [2, 64], got {s}")
    if not (feature_maps.is_contiguous() and boxes.is_contiguous()):
        raise ValueError("roi_crop_pool_cuda takes contiguous tensors")
    lib = _build.load("roi_align", _configure_roi)
    entry = {
        torch.float32: lib.lumi_roi_crop_pool_f32,
        torch.bfloat16: lib.lumi_roi_crop_pool_bf16,
    }.get(feature_maps.dtype)
    if entry is None:
        raise TypeError(
            f"feature maps must be float32 or bfloat16, got "
            f"{feature_maps.dtype}"
        )
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
    x1, y1, x2, y2 = (rois.float() / frame).unbind(-1)
    boxes = torch.stack([y1, x1, y2, x2], dim=-1)

    if sy == sx and pool:
        if use_kernel(feature_maps):
            return roi_crop_pool_cuda(
                feature_maps.contiguous(), boxes.contiguous(), sy
            )
        return roi_crop_pool_reference(feature_maps, boxes, sy)

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
