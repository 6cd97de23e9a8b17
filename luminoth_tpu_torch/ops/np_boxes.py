"""Numpy twins of the box geometry ops, for host-side evaluation code.

The reference keeps its mAP evaluator on host in numpy
(reference: luminoth/utils/bbox_overlap.py:51-94, luminoth/utils/bbox_transform.py);
we do the same: the streaming evaluator fetches detections to host and runs
these functions, keeping the accelerator free for the model.
"""

import numpy as np


def bbox_overlap(boxes1, boxes2):
    """Pairwise IoU, numpy, +1 pixel area convention, safe against /0."""
    boxes1 = np.asarray(boxes1, dtype=np.float64)
    boxes2 = np.asarray(boxes2, dtype=np.float64)
    xi1 = np.maximum(boxes1[:, [0]], boxes2[:, [0]].T)
    yi1 = np.maximum(boxes1[:, [1]], boxes2[:, [1]].T)
    xi2 = np.minimum(boxes1[:, [2]], boxes2[:, [2]].T)
    yi2 = np.minimum(boxes1[:, [3]], boxes2[:, [3]].T)

    intersection = np.maximum(xi2 - xi1 + 1, 0.0) * np.maximum(yi2 - yi1 + 1, 0.0)
    area1 = (boxes1[:, [2]] - boxes1[:, [0]] + 1) * (boxes1[:, [3]] - boxes1[:, [1]] + 1)
    area2 = (boxes2[:, [2]] - boxes2[:, [0]] + 1) * (boxes2[:, [3]] - boxes2[:, [1]] + 1)
    union = area1 + area2.T - intersection

    iou = np.zeros((boxes1.shape[0], boxes2.shape[0]))
    np.divide(intersection, union, out=iou, where=intersection > 0.0)
    return iou


def clip_boxes(boxes, image_shape):
    """Clip xyxy boxes into the image (reference bbox_transform.py:105-122).

    Coordinates clamp to ``[0, dim - 1]``; the label column (if any) is
    untouched. Returns a new array.
    """
    boxes = np.asarray(boxes, dtype=np.float64).copy()
    max_h = image_shape[0] - 1
    max_w = image_shape[1] - 1
    boxes[:, 0] = np.clip(boxes[:, 0], 0, max_w)
    boxes[:, 1] = np.clip(boxes[:, 1], 0, max_h)
    boxes[:, 2] = np.clip(boxes[:, 2], 0, max_w)
    boxes[:, 3] = np.clip(boxes[:, 3], 0, max_h)
    return boxes


def unmap(data, count, inds, fill=0):
    """Scatter a subset back to the full set frame
    (reference bbox_transform.py:125-137): rows not in ``inds`` take
    ``fill``."""
    data = np.asarray(data)
    ret = np.full((count,) + data.shape[1:], fill, dtype=np.float32)
    # int64 coercion: an empty python list would otherwise become a
    # float64 index array, which numpy rejects.
    ret[np.asarray(inds, dtype=np.int64)] = data
    return ret


def encode(boxes, gt_boxes, variances=None):
    """Numpy twin of :func:`luminoth_tpu_torch.ops.boxes.encode`."""
    boxes = np.asarray(boxes, dtype=np.float64)
    gt_boxes = np.asarray(gt_boxes, dtype=np.float64)
    if variances is None:
        variances = [1.0, 1.0]

    bw = boxes[:, 2] - boxes[:, 0] + 1.0
    bh = boxes[:, 3] - boxes[:, 1] + 1.0
    burx = boxes[:, 0] + 0.5 * bw
    bury = boxes[:, 1] + 0.5 * bh

    gw = gt_boxes[:, 2] - gt_boxes[:, 0] + 1.0
    gh = gt_boxes[:, 3] - gt_boxes[:, 1] + 1.0
    gurx = gt_boxes[:, 0] + 0.5 * gw
    gury = gt_boxes[:, 1] + 0.5 * gh

    return np.stack(
        [
            (gurx - burx) / (bw * variances[0]),
            (gury - bury) / (bh * variances[0]),
            np.log(gw / bw) / variances[1],
            np.log(gh / bh) / variances[1],
        ],
        axis=1,
    )


def decode(roi, deltas, variances=None):
    """Numpy twin of :func:`luminoth_tpu_torch.ops.boxes.decode`."""
    roi = np.asarray(roi, dtype=np.float64)
    deltas = np.asarray(deltas, dtype=np.float64)
    if variances is None:
        variances = [1.0, 1.0]

    rw = roi[:, 2] - roi[:, 0] + 1.0
    rh = roi[:, 3] - roi[:, 1] + 1.0
    rurx = roi[:, 0] + 0.5 * rw
    rury = roi[:, 1] + 0.5 * rh

    pred_ur_x = deltas[:, 0] * rw * variances[0] + rurx
    pred_ur_y = deltas[:, 1] * rh * variances[0] + rury
    pred_w = np.exp(deltas[:, 2] * variances[1]) * rw
    pred_h = np.exp(deltas[:, 3] * variances[1]) * rh

    return np.stack(
        [
            pred_ur_x - 0.5 * pred_w,
            pred_ur_y - 0.5 * pred_h,
            pred_ur_x + 0.5 * pred_w - 1.0,
            pred_ur_y + 0.5 * pred_h - 1.0,
        ],
        axis=1,
    )


def _nms_overlap(box, boxes):
    """IoU of one box vs many, NO +1 convention.

    ``tf.image.non_max_suppression`` — the reference's NMS — measures
    overlap without the +1 pixel widths its target-assignment overlap op
    uses; NMS goldens must match that convention.
    """
    xi1 = np.maximum(box[0], boxes[:, 0])
    yi1 = np.maximum(box[1], boxes[:, 1])
    xi2 = np.minimum(box[2], boxes[:, 2])
    yi2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(xi2 - xi1, 0.0) * np.maximum(yi2 - yi1, 0.0)
    area1 = (box[2] - box[0]) * (box[3] - box[1])
    area2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = np.maximum(area1 + area2 - inter, 1e-8)
    return inter / union


def nms(boxes, scores, iou_threshold):
    """Greedy NMS in numpy; returns kept indices in score order.

    Used as the golden reference for unit-testing the on-device static-shape
    NMS kernel (reference behavior: ``tf.image.non_max_suppression`` at
    luminoth/models/fasterrcnn/rpn_proposal.py:152, cross-checked against
    TF itself in tests/test_nms_vs_tf.py).
    """
    boxes = np.asarray(boxes, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores, kind="stable")
    keep = []
    suppressed = np.zeros(len(boxes), dtype=bool)
    for idx in order:
        if suppressed[idx]:
            continue
        keep.append(idx)
        ious = _nms_overlap(boxes[idx], boxes)
        suppressed |= ious > iou_threshold
        suppressed[idx] = True
    return np.asarray(keep, dtype=np.int64)
