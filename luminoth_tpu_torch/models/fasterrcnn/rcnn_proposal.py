"""Final detection stage: per-class decode + NMS + global top-k, batched.

Counterpart of the JAX package's ``models/fasterrcnn/rcnn_proposal.py``.
Classes are groups of the grouped NMS ((image × class) groups, one kernel
launch); outputs are fixed-size (B, total_max_detections) with a ``valid``
mask. Unbatched inputs are auto-wrapped.
"""

import torch

from luminoth_tpu_torch.ops.boxes import clip_boxes, decode
from luminoth_tpu_torch.ops.nms import nms_padded_batch, top_k


def rcnn_proposal(
    proposals,
    bbox_pred,
    cls_prob,
    proposals_valid,
    im_shape,
    num_classes,
    class_max_detections=100,
    class_nms_threshold=0.5,
    total_max_detections=300,
    min_prob_threshold=0.0,
    variances=(0.1, 0.2),
    pre_nms_max_candidates=0,
):
    """Turn RCNN head outputs into final padded detections.

    Args:
        proposals: (B, P, 4) RPN proposals (or (P, 4)).
        bbox_pred: (B, P, 4·C) per-class deltas.
        cls_prob: (B, P, C+1) softmax probabilities (col 0 = background).
        proposals_valid: (B, P) bool.
        im_shape: (B, 2) (height, width).
        pre_nms_max_candidates: if > 0 and < P, keep only that many
            top-scored candidates per class before the NMS (presorted).

    Returns:
        dict with ``objects`` (B, T, 4), ``labels`` (B, T), ``probs``
        (B, T), ``valid`` (B, T).
    """
    device = cls_prob.device
    im_shape = torch.as_tensor(im_shape, dtype=torch.float32, device=device)
    unbatched = cls_prob.dim() == 2
    if unbatched:
        proposals = proposals[None]
        bbox_pred = bbox_pred[None]
        cls_prob = cls_prob[None]
        proposals_valid = proposals_valid[None]
        im_shape = im_shape.reshape(1, 2)

    props = proposals.float()
    b, p = props.shape[0], props.shape[1]
    c = num_classes

    # (B, P, C, 4) → group axis (B·C, P, 4).
    deltas_g = bbox_pred.reshape(b, p, c, 4).transpose(1, 2).reshape(
        b * c, p, 4
    )
    props_g = props[:, None].expand(b, c, p, 4).reshape(b * c, p, 4)
    scores_g = cls_prob[..., 1:].transpose(1, 2).reshape(b * c, p)
    im_shape_g = im_shape.repeat_interleave(c, dim=0)  # (B·C, 2)

    objects = decode(props_g, deltas_g, variances=variances)
    objects = clip_boxes(objects, im_shape_g)
    x1, y1, x2, y2 = objects.unbind(-1)
    area_ok = (
        torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0) > 0.0
    )
    valid_g = (
        proposals_valid[:, None].expand(b, c, p).reshape(b * c, p)
        & area_ok
        & (scores_g >= min_prob_threshold)
    )

    capped = bool(pre_nms_max_candidates and pre_nms_max_candidates < p)
    if capped:
        # Score-sorted cap: every potential suppressor of a kept box stays.
        masked = torch.where(valid_g, scores_g, torch.full_like(scores_g, -1.0))
        top_scores, top_idx = top_k(masked, pre_nms_max_candidates)
        objects = torch.gather(
            objects, 1, top_idx[..., None].expand(-1, -1, 4)
        )
        scores_g = torch.gather(scores_g, 1, top_idx)
        valid_g = top_scores > -1.0

    keep_idx, keep_mask = nms_padded_batch(
        objects, scores_g, float(class_nms_threshold), class_max_detections,
        valid=valid_g, presorted=capped,
    )
    boxes_k = torch.gather(objects, 1, keep_idx[..., None].expand(-1, -1, 4))
    scores_k = torch.gather(scores_g, 1, keep_idx)

    # Flatten classes per image, global top-k by probability.
    m = class_max_detections
    flat_boxes = boxes_k.reshape(b, c * m, 4)
    flat_probs = torch.where(
        keep_mask, scores_k, torch.full_like(scores_k, -1.0)
    ).reshape(b, c * m)
    labels = torch.arange(c, device=device)[None, :, None].expand(
        b, c, m
    ).reshape(b, c * m)

    k = min(total_max_detections, c * m)
    top_probs, top_pos = top_k(flat_probs, k)
    result = {
        "objects": torch.gather(
            flat_boxes, 1, top_pos[..., None].expand(-1, -1, 4)
        ),
        "labels": torch.gather(labels, 1, top_pos),
        "probs": torch.clamp(top_probs, min=0.0),
        "valid": top_probs > -1.0,
    }
    if unbatched:
        result = {key: value[0] for key, value in result.items()}
    return result
