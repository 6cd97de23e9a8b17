"""Region Proposal Network head (counterpart of the JAX package's
``models/fasterrcnn/rpn.py``).

A 3x3 conv (512 channels) with relu6 over the feature map (flax ``SAME``
padding: an even kernel pads one more after than before), then sibling
1x1 convs giving 2·A objectness logits and 4·A box deltas per cell.
(B, H, W, C) in, (B, H·W·A, {2, 4}) out, flattened in (row, col, anchor)
order — the anchor grid's order.
"""

import torch
import torch.nn.functional as F
from torch import nn

from luminoth_tpu_torch.models.base.resnet import Conv2d
from luminoth_tpu_torch.utils.vars import get_activation


class RPN(nn.Module):
    """RPN conv heads (the proposal stage is a plain function)."""

    def __init__(self, in_channels, num_anchors, config):
        super().__init__()
        self.activation = get_activation(
            config.get("activation_function", "relu6")
        )
        kernel = tuple(config.get("kernel_shape", [3, 3]))
        # flax SAME at stride 1: k - 1 in all, (k - 1) // 2 before.
        (top, bottom), (left, right) = (((k - 1) // 2, k // 2)
                                        for k in kernel)
        self.pad = None
        if (top, left) != (bottom, right):
            self.pad, top, left = (left, right, top, bottom), 0, 0
        channels = config.get("num_channels", 512)
        self.conv = Conv2d(in_channels, channels, kernel, padding=(top, left))
        self.cls_conv = Conv2d(channels, num_anchors * 2, 1)
        self.bbox_conv = Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feature_map):
        """(B, H, W, C) NHWC map -> dict of (B, H·W·A, ·) float32 outputs."""
        x = feature_map.permute(0, 3, 1, 2)  # channels_last NCHW view
        if self.pad is not None:
            x = F.pad(x, self.pad)
        rpn_feature = self.activation(self.conv(x))
        batch = feature_map.shape[0]
        # NCHW -> NHWC before flattening: the channel index is anchor-major
        # (a * 2 + k), so (H, W, A·2) flattens to the anchor grid's order.
        cls_score = self.cls_conv(rpn_feature).permute(0, 2, 3, 1)
        bbox_pred = self.bbox_conv(rpn_feature).permute(0, 2, 3, 1)
        cls_score = cls_score.float().reshape(batch, -1, 2)
        bbox_pred = bbox_pred.float().reshape(batch, -1, 4)
        return {
            "rpn_cls_score": cls_score,
            "rpn_cls_prob": torch.softmax(cls_score, dim=-1),
            "rpn_bbox_pred": bbox_pred,
        }
