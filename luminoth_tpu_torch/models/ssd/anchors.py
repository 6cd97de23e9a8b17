"""SSD anchor generation in numpy (a copy of the JAX package's
``models/ssd/anchors.py``), computed once per model and kept on the device
as a constant buffer.

Scales are linearly interpolated between min_scale and max_scale across
feature maps; each map's first anchor uses the geometric mean of its scale
and the next (the last map uses the 0.99 hack); remaining anchors use the
map's scale with the configured aspect ratios. Anchors are laid out in
feature-map cell coordinates centered at (0.5, 0.5), shifted over the
grid, rescaled to image coordinates and clipped. 8096 anchors at 300x300.
"""

import numpy as np

from luminoth_tpu_torch.utils.image import adjust_bboxes


def generate_anchors_reference(ratios, scales, num_anchors, feature_map_shape):
    """Reference anchors for one feature map, in cell coordinates."""
    heights = np.zeros(num_anchors)
    widths = np.zeros(num_anchors)

    if len(scales) > 1:
        widths[0] = heights[0] = np.sqrt(scales[0] * scales[1]) * feature_map_shape[0]
    else:
        # Last feature map: no next scale for the geometric mean.
        heights[0] = scales[0] * feature_map_shape[0] * 0.99
        widths[0] = scales[0] * feature_map_shape[1] * 0.99

    ratios = np.asarray(ratios, dtype=np.float64)[: num_anchors - 1]
    heights[1:] = scales[0] / np.sqrt(ratios) * feature_map_shape[0]
    widths[1:] = scales[0] * np.sqrt(ratios) * feature_map_shape[1]

    x_center = y_center = 0.5
    return np.column_stack(
        [
            x_center - widths / 2,
            y_center - heights / 2,
            x_center + widths / 2,
            y_center + heights / 2,
        ]
    )


def generate_anchors_per_feature_map(feature_map_shape, anchor_reference):
    """Shift the reference anchors over the feature-map grid (cell coords)."""
    shift_x = np.arange(feature_map_shape[1])
    shift_y = np.arange(feature_map_shape[0])
    shift_x, shift_y = np.meshgrid(shift_x, shift_y)
    shifts = np.stack(
        [shift_x.reshape(-1), shift_y.reshape(-1)] * 2, axis=1
    )  # (H*W, 4)
    all_anchors = anchor_reference[None, :, :] + shifts[:, None, :]
    return all_anchors.reshape(-1, 4)


def generate_ssd_anchors(
    feature_map_shapes, min_scale, max_scale, ratios, anchors_per_point, image_shape
):
    """All anchors for an SSD model, concatenated in feature-map order.

    Args:
        feature_map_shapes: list of (h, w) per feature map (static).
        min_scale, max_scale: scale interpolation range.
        ratios: aspect-ratio list (ratio 1 first).
        anchors_per_point: per-map anchor counts.
        image_shape: (height, width) of the model input.

    Returns:
        (total_anchors, 4) float32 xyxy anchors in image coordinates,
        clipped to the image.
    """
    scales = np.linspace(min_scale, max_scale, len(feature_map_shapes))
    image_h, image_w = image_shape

    anchors_list = []
    for i, fm_shape in enumerate(feature_map_shapes):
        reference = generate_anchors_reference(
            ratios, scales[i : i + 2], anchors_per_point[i], fm_shape
        )
        raw = generate_anchors_per_feature_map(fm_shape, reference)
        scaled = adjust_bboxes(raw, fm_shape[0], fm_shape[1], image_h, image_w)
        clipped = np.stack(
            [
                np.clip(scaled[:, 0], 0, image_w - 1),
                np.clip(scaled[:, 1], 0, image_h - 1),
                np.clip(scaled[:, 2], 0, image_w - 1),
                np.clip(scaled[:, 3], 0, image_h - 1),
            ],
            axis=1,
        )
        anchors_list.append(clipped)

    return np.concatenate(anchors_list, axis=0).astype(np.float32)
