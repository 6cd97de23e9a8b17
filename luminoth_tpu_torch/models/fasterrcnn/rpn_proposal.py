"""RPN proposal stage: decode, filter, top-k, NMS — static shapes, batched.

Counterpart of the JAX package's ``models/fasterrcnn/rpn_proposal.py``.
Output is always (B, post_nms_top_n, 4) with an explicit ``valid`` mask,
score-sorted. Unbatched (A, ...) inputs are auto-wrapped.
"""

import torch

from luminoth_tpu_torch.ops.boxes import clip_boxes, decode
from luminoth_tpu_torch.ops.nms import nms_padded_batch, top_k


def _pad_rows(x, extra):
    """Zero-pad axis 1 of a (B, P, ...) tensor by ``extra`` rows."""
    pad = torch.zeros((x.shape[0], extra) + tuple(x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def rpn_proposal(
    rpn_cls_prob,
    rpn_bbox_pred,
    all_anchors,
    im_shape,
    pre_nms_top_n=12000,
    post_nms_top_n=2000,
    nms_threshold=0.7,
    min_size=0,
    apply_nms=True,
    clip_after_nms=False,
    filter_outside_anchors=False,
    min_prob_threshold=0.0,
):
    """Produce padded, score-sorted object proposals.

    Args:
        rpn_cls_prob: (B, A, 2) softmax (bg, fg) probabilities (or (A, 2)).
        rpn_bbox_pred: (B, A, 4) box deltas.
        all_anchors: (A, 4) anchors (shared across the batch).
        im_shape: (B, 2) actual (height, width) per image.

    Returns:
        dict with ``proposals`` (B, P, 4), ``scores`` (B, P), ``valid``
        (B, P) where P = post_nms_top_n.
    """
    device = rpn_cls_prob.device
    im_shape = torch.as_tensor(im_shape, dtype=torch.float32, device=device)
    unbatched = rpn_cls_prob.dim() == 2
    if unbatched:
        rpn_cls_prob = rpn_cls_prob[None]
        rpn_bbox_pred = rpn_bbox_pred[None]
        im_shape = im_shape.reshape(1, 2)

    scores = rpn_cls_prob[..., 1]  # (B, A)
    anchors = all_anchors.float()

    valid = torch.ones(scores.shape, dtype=torch.bool, device=device)
    if filter_outside_anchors:
        heights = im_shape[:, 0:1]
        widths = im_shape[:, 1:2]
        valid &= (
            (anchors[None, :, 0] >= 0)
            & (anchors[None, :, 1] >= 0)
            & (anchors[None, :, 2] < widths)
            & (anchors[None, :, 3] < heights)
        )

    proposals = decode(anchors[None], rpn_bbox_pred)  # (B, A, 4)

    valid &= scores >= min_prob_threshold
    x1, y1, x2, y2 = proposals.unbind(-1)
    valid &= (
        torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0) > 0.0
    )
    if min_size:
        valid &= (x2 - x1 + 1.0 >= min_size) & (y2 - y1 + 1.0 >= min_size)

    if not clip_after_nms:
        proposals = clip_boxes(proposals, im_shape)

    # Top pre_nms_top_n candidates by score among the valid ones.
    k = min(pre_nms_top_n, scores.shape[1])
    masked_scores = torch.where(valid, scores, torch.full_like(scores, -1.0))
    top_scores, top_idx = top_k(masked_scores, k)  # (B, K)
    top_proposals = torch.gather(
        proposals, 1, top_idx[..., None].expand(-1, -1, 4)
    )
    top_valid = top_scores > -1.0

    if apply_nms:
        keep_idx, keep_mask = nms_padded_batch(
            top_proposals,
            top_scores,
            float(nms_threshold),
            post_nms_top_n,
            valid=top_valid,
            # top_k output is descending with invalids (-1) at the tail.
            presorted=True,
        )
        out_proposals = torch.gather(
            top_proposals, 1, keep_idx[..., None].expand(-1, -1, 4)
        )
        out_scores = torch.where(
            keep_mask, torch.gather(top_scores, 1, keep_idx),
            torch.zeros_like(top_scores[:, :1]),
        )
        out_valid = keep_mask
    else:
        p = min(post_nms_top_n, k)
        out_proposals = top_proposals[:, :p]
        out_scores = torch.where(
            top_valid[:, :p], top_scores[:, :p],
            torch.zeros_like(top_scores[:, :1]),
        )
        out_valid = top_valid[:, :p]
        if post_nms_top_n > p:
            extra = post_nms_top_n - p
            out_proposals = _pad_rows(out_proposals, extra)
            out_scores = _pad_rows(out_scores, extra)
            out_valid = _pad_rows(out_valid, extra)

    if clip_after_nms:
        out_proposals = clip_boxes(out_proposals, im_shape)

    result = {
        "proposals": out_proposals,
        "scores": out_scores,
        "valid": out_valid,
    }
    if unbatched:
        result = {key: value[0] for key, value in result.items()}
    return result
