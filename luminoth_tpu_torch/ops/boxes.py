"""Bounding-box geometry on torch tensors.

Counterpart of ``luminoth_tpu/ops/boxes.py``, with the same conventions:
boxes are ``(x1, y1, x2, y2)`` with the reference's "+1 pixel" widths
(``width = x2 - x1 + 1``), and decode subtracts 1 on the max corner.
Every function broadcasts over leading dimensions: boxes are ``(..., N, 4)``.
"""

import torch


def split_corners(boxes):
    """Split a (..., 4) box tensor into x1, y1, x2, y2 of shape (..., 1)."""
    return torch.split(boxes.float(), 1, dim=-1)


def get_width_upright(boxes):
    """Width, height and center ("upright") point with +1 pixel convention."""
    x1, y1, x2, y2 = split_corners(boxes)
    width = x2 - x1 + 1.0
    height = y2 - y1 + 1.0
    urx = x1 + 0.5 * width
    ury = y1 + 0.5 * height
    return width, height, urx, ury


def encode(boxes, gt_boxes, variances=None):
    """Encode ``gt_boxes`` as ``(dx, dy, dw, dh)`` deltas from ``boxes``."""
    bw, bh, burx, bury = get_width_upright(boxes)
    gw, gh, gurx, gury = get_width_upright(gt_boxes)
    if variances is None:
        variances = [1.0, 1.0]

    targets_dx = (gurx - burx) / (bw * variances[0])
    targets_dy = (gury - bury) / (bh * variances[0])
    targets_dw = torch.log(gw / bw) / variances[1]
    targets_dh = torch.log(gh / bh) / variances[1]
    return torch.cat([targets_dx, targets_dy, targets_dw, targets_dh], dim=-1)


def decode(roi, deltas, variances=None):
    """Apply predicted deltas to reference boxes (inverse of :func:`encode`)."""
    rw, rh, rurx, rury = get_width_upright(roi)
    dx, dy, dw, dh = torch.split(deltas.float(), 1, dim=-1)
    if variances is None:
        variances = [1.0, 1.0]

    pred_ur_x = dx * rw * variances[0] + rurx
    pred_ur_y = dy * rh * variances[0] + rury
    pred_w = torch.exp(dw * variances[1]) * rw
    pred_h = torch.exp(dh * variances[1]) * rh

    bbox_x1 = pred_ur_x - 0.5 * pred_w
    bbox_y1 = pred_ur_y - 0.5 * pred_h
    # The extra pixel on the max corner closes the +1-width round trip.
    bbox_x2 = pred_ur_x + 0.5 * pred_w - 1.0
    bbox_y2 = pred_ur_y + 0.5 * pred_h - 1.0
    return torch.cat([bbox_x1, bbox_y1, bbox_x2, bbox_y2], dim=-1)


def clip_boxes(boxes, im_shape):
    """Clip boxes to ``[0, W-1] x [0, H-1]``.

    ``im_shape`` is a (height, width) pair or a (..., 2) tensor that
    broadcasts over the leading box dims.
    """
    boxes = boxes.float()
    im_shape = torch.as_tensor(
        im_shape, dtype=torch.float32, device=boxes.device
    )
    height = im_shape[..., 0][..., None, None]
    width = im_shape[..., 1][..., None, None]

    x1, y1, x2, y2 = split_corners(boxes)
    zero = torch.zeros((), device=boxes.device)
    x1 = torch.clamp(x1, zero, width - 1.0)
    x2 = torch.clamp(x2, zero, width - 1.0)
    y1 = torch.clamp(y1, zero, height - 1.0)
    y2 = torch.clamp(y2, zero, height - 1.0)
    return torch.cat([x1, y1, x2, y2], dim=-1)


def iou_matrix(boxes1, boxes2, offset=1.0):
    """Pairwise IoU (..., N, M) between (..., N, 4) and (..., M, 4) boxes.

    ``offset`` 1.0 is the +1-pixel convention of target assignment; 0.0 is
    the convention of NMS (no +1). Clamped at 0; the union is guarded at
    1e-8 for degenerate boxes.
    """
    x11, y11, x12, y12 = split_corners(boxes1)
    x21, y21, x22, y22 = (
        v.transpose(-1, -2) for v in split_corners(boxes2)
    )

    xi1 = torch.maximum(x11, x21)
    yi1 = torch.maximum(y11, y21)
    xi2 = torch.minimum(x12, x22)
    yi2 = torch.minimum(y12, y22)

    intersection = torch.clamp(xi2 - xi1 + offset, min=0.0) * torch.clamp(
        yi2 - yi1 + offset, min=0.0
    )
    area1 = (x12 - x11 + offset) * (y12 - y11 + offset)
    area2 = (x22 - x21 + offset) * (y22 - y21 + offset)
    union = torch.clamp(area1 + area2 - intersection, min=1e-8)
    return torch.clamp(intersection / union, min=0.0)
