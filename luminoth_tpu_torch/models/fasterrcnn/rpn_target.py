"""RPN anchor target assignment (counterpart of the JAX package's
``models/fasterrcnn/rpn_target.py``), batched over images.

Same semantics: anchors (partly) outside the image (± ``allowed_border``)
are ignored; background below ``background_threshold_high`` IoU, foreground
at or above ``foreground_threshold``; every gt's best anchors (all IoU ties)
are foreground; at most ``foreground_fraction · minibatch_size`` positives
are kept at random, then backgrounds fill the minibatch; box targets are
``encode`` against each anchor's best gt, zero unless foreground.

The random draw is a uniform priority per anchor, one vector for the
foreground quota and one for the background quota. They come from a
``torch.Generator``, or are given (``priorities``) to reproduce another
draw exactly: the JAX package draws ``uniform(split(key)[i], (A,))``.
"""

import torch

from luminoth_tpu_torch.ops.boxes import encode, iou_matrix
from luminoth_tpu_torch.ops.select import top_k_mask
from luminoth_tpu_torch.parallel.mesh import rand_rows


def draw_priorities(shape, generator, device):
    """The (fg, bg) pair of uniform [0, 1) priorities for one stage (a
    data-parallel rank draws the global batch's and keeps its rows)."""
    return tuple(rand_rows(shape, generator, device) for _ in range(2))


def keep_random_quota(candidate_mask, quota, priorities):
    """Keep at most ``quota`` True entries per row, the highest priorities.

    ``candidate_mask`` is (B, n), ``quota`` an int or a (B,) tensor.
    """
    masked = torch.where(candidate_mask, priorities,
                         torch.full_like(priorities, -1.0))
    return candidate_mask & top_k_mask(masked, quota)


def rpn_target_assign(
    all_anchors,
    gt_boxes,
    im_shape,
    priorities,
    allowed_border=0,
    clobber_positives=False,
    foreground_threshold=0.7,
    background_threshold_high=0.3,
    foreground_fraction=0.5,
    minibatch_size=256,
):
    """Label anchors and build RPN regression targets for a batch.

    Args:
        all_anchors: (A, 4) anchors.
        gt_boxes: (B, G, 5) padded ground truth (label < 0 = padding).
        im_shape: (B, 2) (height, width) of the unpadded images.
        priorities: ``(fg, bg)`` (B, A) uniform priorities
            (:func:`draw_priorities`).

    Returns:
        ``(labels, bbox_targets, max_overlaps)``: (B, A) float in
        {-1, 0, 1}, (B, A, 4) targets (zeros unless fg), (B, A) best-gt IoU
        (0 outside the image).
    """
    anchors = all_anchors.float()
    gt = gt_boxes.float()
    im_shape = im_shape.float()
    fg_priority, bg_priority = priorities

    inside = (
        (anchors[None, :, 0] >= -allowed_border)
        & (anchors[None, :, 1] >= -allowed_border)
        & (anchors[None, :, 2] < im_shape[:, 1:2] + allowed_border)
        & (anchors[None, :, 3] < im_shape[:, 0:1] + allowed_border)
    )  # (B, A)

    gt_valid = gt[..., 4] >= 0  # (B, G)
    overlaps = iou_matrix(anchors.expand(gt.shape[0], -1, -1), gt[..., :4])
    overlaps = torch.where(gt_valid[:, None, :], overlaps,
                           torch.full_like(overlaps, -1.0))
    # Outside anchors must not influence per-gt maxima.
    overlaps_inside = torch.where(inside[..., None], overlaps,
                                  torch.full_like(overlaps, -1.0))

    max_overlaps = overlaps_inside.amax(dim=2)  # (B, A)
    # argmax returns the first maximum, as jnp.argmax does.
    argmax_gt = overlaps_inside.argmax(dim=2)

    labels = torch.full_like(max_overlaps, -1.0)
    background = inside & (max_overlaps < background_threshold_high)
    if not clobber_positives:
        labels = torch.where(background, torch.zeros_like(labels), labels)

    # Best anchor(s) per gt: all IoU ties count.
    gt_max = overlaps_inside.amax(dim=1, keepdim=True)  # (B, 1, G)
    is_best = (
        (overlaps_inside == gt_max) & gt_valid[:, None, :] & (gt_max > -1.0)
    ).any(dim=2)
    ones = torch.ones_like(labels)
    labels = torch.where(inside & is_best, ones, labels)
    labels = torch.where(inside & (max_overlaps >= foreground_threshold),
                         ones, labels)
    if clobber_positives:
        labels = torch.where(background, torch.zeros_like(labels), labels)

    # Random fg/bg subsampling.
    fg_mask = labels == 1.0
    fg_kept = keep_random_quota(
        fg_mask, int(foreground_fraction * minibatch_size), fg_priority
    )
    labels = torch.where(fg_mask & ~fg_kept, -ones, labels)

    num_bg_quota = minibatch_size - (labels == 1.0).sum(dim=1)
    bg_mask = labels == 0.0
    bg_kept = keep_random_quota(bg_mask, num_bg_quota, bg_priority)
    labels = torch.where(bg_mask & ~bg_kept, -ones, labels)

    matched_gt = torch.gather(
        gt[..., :4], 1, argmax_gt[..., None].expand(-1, -1, 4)
    )
    bbox_targets = encode(anchors.expand_as(matched_gt), matched_gt)
    bbox_targets = torch.where((labels == 1.0)[..., None], bbox_targets,
                               torch.zeros_like(bbox_targets))
    max_overlaps = torch.where(inside, max_overlaps,
                               torch.zeros_like(max_overlaps))
    return labels, bbox_targets, max_overlaps
