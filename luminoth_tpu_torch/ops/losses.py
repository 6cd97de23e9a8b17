"""Detection losses (counterpart of ``luminoth_tpu/ops/losses.py``).

Not on the serving path: they wait here for the training port.
"""

import torch


def smooth_l1_loss(bbox_prediction, bbox_target, sigma=3.0):
    """σ-parameterized smooth-L1, summed over the last axis.

    ``0.5·σ²·x²`` when ``|x| < 1/σ²`` else ``|x| − 0.5/σ²``.
    """
    sigma2 = sigma**2
    abs_diff = torch.abs(bbox_prediction - bbox_target)
    loss = torch.where(
        abs_diff < 1.0 / sigma2,
        0.5 * sigma2 * torch.square(abs_diff),
        abs_diff - 0.5 / sigma2,
    )
    return torch.sum(loss, dim=-1)


def softmax_cross_entropy(logits, labels_one_hot):
    """Per-row softmax cross-entropy; labels are one-hot (possibly smoothed)."""
    log_probs = logits - torch.amax(logits, dim=-1, keepdim=True)
    log_probs = log_probs - torch.log(
        torch.sum(torch.exp(log_probs), dim=-1, keepdim=True)
    )
    return -torch.sum(labels_one_hot * log_probs, dim=-1)
