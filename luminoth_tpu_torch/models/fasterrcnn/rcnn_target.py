"""RCNN proposal target assignment and minibatch selection (counterpart of
the JAX package's ``models/fasterrcnn/rcnn_target.py``), batched over
images.

Same semantics: background band ``background_threshold_low <= IoU <
high``; foreground at or above ``foreground_threshold`` takes its best gt's
class + 1; the single best proposal of each gt is foreground whatever its
IoU, and when two gts claim one proposal the highest gt index wins (a dense
claim matrix, as in the JAX version); invalid proposals are ignored; at
most ``foreground_fraction · minibatch_size`` positives are kept at random
(dropped ones become ``-label``), then backgrounds fill the minibatch;
``encode`` targets with variances for positives only.
"""

import torch

from luminoth_tpu_torch.models.fasterrcnn.rpn_target import keep_random_quota
from luminoth_tpu_torch.ops.boxes import encode, iou_matrix


def rcnn_target_assign(
    proposals,
    proposals_valid,
    gt_boxes,
    priorities,
    foreground_threshold=0.5,
    background_threshold_high=0.5,
    background_threshold_low=0.0,
    foreground_fraction=0.25,
    minibatch_size=256,
    variances=(0.1, 0.2),
):
    """Label RPN proposals against ground truth for a batch.

    Args:
        proposals: (B, P, 4) padded proposals.
        proposals_valid: (B, P) bool mask of real proposals.
        gt_boxes: (B, G, 5) padded ground truth (label < 0 = padding).
        priorities: ``(fg, bg)`` (B, P) uniform priorities.

    Returns:
        ``(labels, bbox_targets)``: (B, P) float labels (-1 ignore, 0 bg,
        1..C fg) and (B, P, 4) encoded offsets (zeros unless fg).
    """
    props = proposals.float()
    gt = gt_boxes.float()
    fg_priority, bg_priority = priorities
    num_proposals, num_gt = props.shape[1], gt.shape[1]

    gt_valid = gt[..., 4] >= 0  # (B, G)
    overlaps = iou_matrix(props, gt[..., :4])  # (B, P, G)
    invalid = ~(gt_valid[:, None, :] & proposals_valid[..., None])
    overlaps = overlaps.masked_fill(invalid, -1.0)

    max_overlaps = overlaps.amax(dim=2)  # (B, P)
    # With no valid gt every overlap is the -1 sentinel: all background.
    max_overlaps = torch.where(gt_valid.any(dim=1, keepdim=True),
                               max_overlaps, torch.zeros_like(max_overlaps))
    best_gt_idx = overlaps.argmax(dim=2)

    bg_cond = (
        (max_overlaps >= background_threshold_low)
        & (max_overlaps < background_threshold_high)
        & proposals_valid
    )
    iou_is_fg = (max_overlaps >= foreground_threshold) & proposals_valid

    # The best proposal of each gt, gated on it overlapping at all; ties
    # between gts go to the highest gt index.
    best_proposal_idx = overlaps.argmax(dim=1)  # (B, G)
    gt_best = overlaps.amax(dim=1)
    best_valid = gt_valid & (gt_best > -1.0)
    claim = best_valid[..., None] & (
        torch.arange(num_proposals, device=props.device)
        == best_proposal_idx[..., None]
    )  # (B, G, P)
    winner_gt = (num_gt - 1) - claim.flip(1).long().argmax(dim=1)  # (B, P)
    is_best = claim.any(dim=1)

    matched_idx = torch.where(is_best, winner_gt, best_gt_idx)
    matched_gt = torch.gather(gt, 1, matched_idx[..., None].expand(-1, -1, 5))
    labels = torch.where(
        is_best | iou_is_fg,
        matched_gt[..., 4] + 1.0,
        torch.where(bg_cond, 0.0, -1.0),
    )

    # Subsample: at most max_fg positives, then fill with backgrounds.
    fg_cond = (iou_is_fg | is_best) & (labels > 0)
    fg_kept = keep_random_quota(
        fg_cond, int(foreground_fraction * minibatch_size), fg_priority
    )
    labels = torch.where(fg_cond & ~fg_kept, -labels, labels)

    max_bg = minibatch_size - (labels > 0).sum(dim=1)
    bg_mask = labels == 0.0
    bg_kept = keep_random_quota(bg_mask, max_bg, bg_priority)
    labels = torch.where(bg_mask & ~bg_kept, -1.0, labels)

    bbox_targets = encode(props, matched_gt[..., :4], variances=variances)
    bbox_targets = torch.where((labels > 0)[..., None], bbox_targets,
                               torch.zeros_like(bbox_targets))
    return labels, bbox_targets


def select_minibatch(labels, minibatch_size):
    """Fixed-size indices of the proposals kept for the ROI stage.

    All ``label >= 0`` rows of each image first, in index order (a stable
    sort), then arbitrary padding rows.

    Returns:
        ``(indices, mask)``: (B, M) int64 indices and (B, M) bool validity.
    """
    selected = labels >= 0
    order = torch.sort((~selected).to(torch.uint8), dim=1, stable=True)
    indices = order.indices[:, :minibatch_size]
    return indices, torch.gather(selected, 1, indices)
