"""SSD detection stage: decode, NMS and the global top-k, batched.

Counterpart of ``luminoth_tpu/models/ssd/proposal.py``, with its two paths,
both through the grouped NMS of ``ops/nms.py`` (kernel K1 on CUDA, one
launch per forward):

* **fused per image** when ``min_prob_threshold >= 0.5`` and
  ``class_max_detections >= total_max_detections`` (the base config's
  serving defaults): a softmax probability of at least 0.5 admits at most
  one class per anchor, so each anchor enters as its best class, the
  boxes shifted by ``class * 1e4`` so that classes never overlap, and one
  NMS per image (B groups of the top ``pre_nms_max_candidates``) is the
  per-class sweep exactly;
* **per class** otherwise (eval sets the floor to 0): (image × class)
  groups, B·C of them, each the class's top ``pre_nms_max_candidates``
  anchors, then the global top ``total_max_detections`` per image.

Every descending selection is a stable sort (``ops/nms.top_k``), as
``jax.lax.top_k`` orders ties. Outputs are fixed-size with a ``valid``
mask; unbatched inputs are auto-wrapped.
"""

import torch

from luminoth_tpu_torch.ops.boxes import clip_boxes, decode
from luminoth_tpu_torch.ops.nms import nms_padded_batch, top_k

CLASS_SHIFT = 1e4  # px between the classes' coordinate islands (fused path)


def _gather_boxes(boxes, index):
    """``boxes[g, index[g]]`` for (G, N, 4) boxes and (G, K) indices."""
    return torch.gather(boxes, 1, index[..., None].expand(-1, -1, 4))


def ssd_proposal(
    cls_prob,
    loc_pred,
    all_anchors,
    im_shape,
    num_classes,
    class_nms_threshold,
    class_max_detections,
    total_max_detections,
    min_prob_threshold,
    variances,
    pre_nms_max_candidates=1000,
):
    """Turn SSD's outputs into final padded detections.

    Args:
        cls_prob: (B, A, C+1) softmax probabilities (col 0 = background).
        loc_pred: (B, A, 4) box offsets.
        all_anchors: (A, 4) anchors.
        im_shape: (height, width) to clip against.
        pre_nms_max_candidates: candidate cap per NMS group.

    Returns:
        dict with ``objects`` (B, T, 4), ``labels`` (B, T), ``probs`` (B, T)
        and ``valid`` (B, T) for T = total_max_detections.
    """
    unbatched = cls_prob.dim() == 2
    if unbatched:
        cls_prob = cls_prob[None]
        loc_pred = loc_pred[None]

    anchors = all_anchors.float()
    b, num_anchors = cls_prob.shape[0], anchors.shape[0]
    c = num_classes
    k = min(pre_nms_max_candidates, num_anchors)

    decoded = decode(anchors[None], loc_pred, variances=variances)
    clipped = clip_boxes(decoded, im_shape)  # (B, A, 4)
    x1, y1, x2, y2 = clipped.unbind(-1)
    area_valid = (
        torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0) > 0.0
    )  # (B, A)

    fused = (float(min_prob_threshold) >= 0.5
             and class_max_detections >= total_max_detections)
    if fused:
        best_prob, best_class = torch.max(cls_prob[..., 1:], dim=-1)
        valid_a = (best_prob >= min_prob_threshold) & area_valid
        masked = torch.where(valid_a, best_prob, torch.full_like(best_prob,
                                                                 -1.0))
        top_scores, top_idx = top_k(masked, k)  # (B, K)
        boxes_c = _gather_boxes(clipped, top_idx)
        classes_c = torch.gather(best_class, 1, top_idx)
        nms_boxes = boxes_c + classes_c[..., None].float() * CLASS_SHIFT
        keep_idx, keep_mask = nms_padded_batch(
            nms_boxes, top_scores, float(class_nms_threshold),
            total_max_detections, valid=top_scores > -1.0, presorted=True,
        )
        top_probs = torch.where(
            keep_mask, torch.gather(top_scores, 1, keep_idx),
            torch.full_like(keep_idx, -1.0, dtype=torch.float32),
        )
        result = {
            "objects": _gather_boxes(boxes_c, keep_idx),
            "labels": torch.gather(classes_c, 1, keep_idx),
            "probs": torch.clamp(top_probs, min=0.0),
            "valid": keep_mask,
        }
    else:
        scores = cls_prob[..., 1:].transpose(1, 2)  # (B, C, A)
        valid = (scores >= min_prob_threshold) & area_valid[:, None, :]
        masked = torch.where(valid, scores, torch.full_like(scores, -1.0))
        top_scores, top_idx = top_k(masked, k)  # (B, C, K)
        # The regression is class-agnostic: each class gathers its
        # candidates from the image's boxes.
        boxes_g = _gather_boxes(
            clipped[:, None].expand(b, c, num_anchors, 4).reshape(
                b * c, num_anchors, 4),
            top_idx.reshape(b * c, k),
        )  # (B·C, K, 4)
        scores_g = top_scores.reshape(b * c, k)
        keep_idx, keep_mask = nms_padded_batch(
            boxes_g, scores_g, float(class_nms_threshold),
            class_max_detections, valid=scores_g > -1.0, presorted=True,
        )
        m = class_max_detections
        flat_boxes = _gather_boxes(boxes_g, keep_idx).reshape(b, c * m, 4)
        flat_probs = torch.where(
            keep_mask, torch.gather(scores_g, 1, keep_idx),
            torch.full_like(keep_idx, -1.0, dtype=torch.float32),
        ).reshape(b, c * m)
        labels = torch.arange(c, device=cls_prob.device)[None, :, None]
        labels = labels.expand(b, c, m).reshape(b, c * m)
        top_probs, top_pos = top_k(flat_probs, min(total_max_detections,
                                                   c * m))
        result = {
            "objects": _gather_boxes(flat_boxes, top_pos),
            "labels": torch.gather(labels, 1, top_pos),
            "probs": torch.clamp(top_probs, min=0.0),
            "valid": top_probs > -1.0,
        }
    if unbatched:
        result = {key: value[0] for key, value in result.items()}
    return result
