"""Anchor generation.

Counterpart of ``luminoth_tpu/ops/anchors.py``: the (A, 4) reference set is
built in numpy, then shifted over every feature-map cell on the device.
"""

import numpy as np
import torch


def generate_anchors_reference(base_size, aspect_ratios, scales):
    """(num_ratios * num_scales, 4) reference anchors centered at 0.

    ``aspect_ratio = height / width``; scales multiply the base size on each
    side. Corners are ``±(size - 1) / 2``.
    """
    scales_grid, ratios_grid = np.meshgrid(
        np.asarray(scales, dtype=np.float64),
        np.asarray(aspect_ratios, dtype=np.float64),
    )
    base_scales = scales_grid.reshape(-1)
    base_ratios = ratios_grid.reshape(-1)

    ratio_sqrts = np.sqrt(base_ratios)
    heights = base_scales * ratio_sqrts * base_size
    widths = base_scales / ratio_sqrts * base_size

    anchors = np.column_stack(
        [
            -(widths - 1) / 2,
            -(heights - 1) / 2,
            (widths - 1) / 2,
            (heights - 1) / 2,
        ]
    )

    real_heights = (anchors[:, 3] - anchors[:, 1]).astype(np.int64)
    real_widths = (anchors[:, 2] - anchors[:, 0]).astype(np.int64)
    if (real_widths == 0).any() or (real_heights == 0).any():
        raise ValueError(
            "base_size {} is too small for aspect_ratios and scales.".format(
                base_size
            )
        )
    return anchors.astype(np.float32)


def generate_anchors_grid(anchors_reference, anchor_stride, feature_map_shape,
                          device=None):
    """Shift the reference anchors over every feature-map cell.

    Returns (H * W * A, 4) anchors in input-image coordinates, ordered with
    x fastest within a row and the A anchors of a cell innermost — the
    order of the RPN head's flattened outputs.
    """
    fm_h, fm_w = int(feature_map_shape[0]), int(feature_map_shape[1])
    shift_x = torch.arange(fm_w, dtype=torch.float32, device=device)
    shift_y = torch.arange(fm_h, dtype=torch.float32, device=device)
    shift_y, shift_x = torch.meshgrid(
        shift_y * anchor_stride, shift_x * anchor_stride, indexing="ij"
    )  # (H, W) each
    shifts = torch.stack(
        [shift_x.reshape(-1), shift_y.reshape(-1)] * 2, dim=1
    )  # (H*W, 4) as (x, y, x, y)

    ref = torch.as_tensor(
        anchors_reference, dtype=torch.float32, device=device
    )
    return (ref[None, :, :] + shifts[:, None, :]).reshape(-1, 4)
