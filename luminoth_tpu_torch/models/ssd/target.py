"""SSD anchor target assignment with online hard-negative mining, batched.

Counterpart of ``luminoth_tpu/models/ssd/target.py`` (which is vmapped over
the batch; here every tensor carries the batch axis). Dense labels per
anchor: -1 ignore, 0 background (picked by hard mining), 1..C foreground
class. Ground truth arrives padded, (B, G, 5) with label < 0 on padding
rows.

Priority, as in the JAX package: an anchor that is some gt's best anchor
is claimed by the last such gt (the reference writes gts in order); others
are foreground at IoU >= ``foreground_threshold`` with their best gt. Hard
negatives are the ``hard_negative_ratio × num_fg`` background candidates
(IoU <= ``background_threshold_high``, not foreground) of highest
foreground probability, through ``ops/select.top_k_mask`` and its tie rule
(ascending anchor index).
"""

import torch

from luminoth_tpu_torch.ops.boxes import encode, iou_matrix
from luminoth_tpu_torch.ops.select import top_k_mask


def ssd_target_assign(
    probs,
    all_anchors,
    gt_boxes,
    num_classes,
    foreground_threshold,
    background_threshold_high,
    hard_negative_ratio,
    variances,
):
    """Class and box-regression targets of every anchor.

    Args:
        probs: (B, A, C+1) softmax probabilities (for hard mining).
        all_anchors: (A, 4) anchors in image coordinates.
        gt_boxes: (B, G, 5) padded ``(x1, y1, x2, y2, label)``.
        num_classes: C (unused: the labels come from the gt rows).

    Returns:
        ``(class_targets, bbox_offsets_targets)``: (B, A) float labels
        (-1/0/1..C) and (B, A, 4) encoded offsets (zero off foreground).
    """
    del num_classes
    anchors = all_anchors.float()
    gt = gt_boxes.float()
    num_gt = gt.shape[1]

    gt_valid = gt[..., 4] >= 0  # (B, G)
    overlaps = iou_matrix(anchors, gt[..., :4])  # (B, A, G)
    overlaps = torch.where(gt_valid[:, None, :], overlaps,
                           torch.full_like(overlaps, -1.0))
    max_overlaps, best_gt_for_anchor = torch.max(overlaps, dim=2)  # (B, A)
    iou_is_fg = max_overlaps >= foreground_threshold

    # Each valid gt claims its best anchor (the first, on ties); an anchor
    # claimed by several gts goes to the last of them.
    best_anchor_for_gt = torch.argmax(overlaps, dim=1)  # (B, G)
    arange_a = torch.arange(anchors.shape[0], device=anchors.device)
    claim = gt_valid[..., None] & (
        arange_a[None, None, :] == best_anchor_for_gt[..., None])  # (B, G, A)
    gt_index = torch.arange(num_gt, device=anchors.device)[None, :, None]
    winner_gt = torch.amax(
        torch.where(claim, gt_index, torch.full_like(gt_index, -1)), dim=1)
    claimed = winner_gt >= 0  # (B, A)

    matched_idx = torch.where(claimed, winner_gt, best_gt_for_anchor)
    matched_gt = torch.gather(gt, 1, matched_idx[..., None].expand(-1, -1, 5))
    anchors_label = torch.where(claimed | iou_is_fg, matched_gt[..., 4] + 1.0,
                                torch.full_like(max_overlaps, -1.0))

    # Online hard negative mining: the strongest-scoring backgrounds.
    max_cls_probs = torch.amax(probs[..., 1:], dim=-1).float()
    bg_candidate = (max_overlaps <= background_threshold_high) & (
        anchors_label <= 0)
    mining_scores = torch.where(bg_candidate, max_cls_probs,
                                torch.full_like(max_cls_probs, -1.0))
    num_fg = torch.sum(anchors_label > 0, dim=1)
    num_bg = (num_fg.float() * hard_negative_ratio).int()
    set_bg = top_k_mask(mining_scores, num_bg) & (mining_scores > -1.0)
    anchors_label = torch.where(set_bg, torch.zeros_like(anchors_label),
                                anchors_label)

    # A claimed anchor regresses toward its claiming gt.
    bbox_targets = encode(anchors, matched_gt[..., :4], variances=variances)
    bbox_targets = torch.where((anchors_label > 0)[..., None], bbox_targets,
                               torch.zeros_like(bbox_targets))
    return anchors_label, bbox_targets
