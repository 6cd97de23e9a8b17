"""Truncated VGG-16 backbone in PyTorch (SSD's feature source).

Counterpart of ``luminoth_tpu/models/base/vgg.py`` with ``truncated=True``:
conv1_1 .. conv5_3, each a 3x3 TF-``SAME`` conv and a relu, with a 2x2
stride-2 ``VALID`` max-pool after stages 1-4. At 300x300 the pools give
150, 75, 37 and 18: conv4_3 is 37x37 and conv5_3 18x18 (not the canonical
38/19). The full trunk with fc6-fc8 (the JAX package's ``vgg_16``
architecture for Faster R-CNN) is not ported.

Modules are NCHW and run on ``torch.channels_last`` tensors. Parameters
stay float32 and are cast to the input's dtype, as in ``resnet.py``.
Module names follow the flax paths: the flax module ``conv1/conv1_1`` is
``conv1.conv1_1`` here, which ``utils/weights.torch_key`` maps back.
"""

import torch
import torch.nn.functional as F
from torch import nn

from luminoth_tpu_torch.models.base.resnet import Conv2d

_STAGES = ((2, 64, "conv1"), (2, 128, "conv2"), (3, 256, "conv3"),
           (3, 512, "conv4"), (3, 512, "conv5"))


def same_padding(size, kernel, stride, dilation=1):
    """TF ``SAME`` ``(before, after)`` padding of one spatial axis of
    ``size``: the total is split with the odd pixel after."""
    kernel_eff = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel_eff - size, 0)
    return total // 2, total - total // 2


class TFConv2d(Conv2d):
    """A biased conv with TF padding, in the input's dtype.

    ``SAME`` padding is computed at each call from the input's size; an
    asymmetric pad (an odd total, as at stride 2 on an even map) goes
    through ``F.pad``, a symmetric one through the conv itself. ``VALID``
    does not pad.
    """

    def __init__(self, in_channels, features, kernel_size, stride=1,
                 dilation=1, padding="SAME"):
        super().__init__(in_channels, features, kernel_size, stride=stride,
                         dilation=dilation, bias=True)
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.tf_padding = padding

    def forward(self, x):
        pad = (0, 0)
        if self.tf_padding == "SAME":
            (top, bottom), (left, right) = (
                same_padding(x.shape[2 + i], self.kernel_size[i],
                             self.stride[i], self.dilation[i])
                for i in range(2)
            )
            if top == bottom and left == right:
                pad = (top, left)
            else:
                x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        self.stride, pad, self.dilation)


class VGG16(nn.Module):
    """VGG-16 conv trunk up to conv5_3, with per-layer endpoints."""

    def __init__(self, truncated=True):
        super().__init__()
        if not truncated:
            raise NotImplementedError(
                "the full VGG-16 (fc6-fc8) is not ported to PyTorch yet; "
                "truncated_vgg_16 is")
        in_channels = 3
        for reps, features, stage in _STAGES:
            layers = nn.ModuleDict()
            for i in range(1, reps + 1):
                layers[f"{stage}_{i}"] = TFConv2d(in_channels, features, 3)
                in_channels = features
            self.add_module(stage, layers)
        self.out_channels = in_channels

    def forward(self, x):
        """NCHW ``x`` in the compute dtype → ``(conv5_3, endpoints)``;
        endpoints are named as in the JAX package (``conv4/conv4_3``,
        ``pool1``, ..., ``output``)."""
        endpoints = {}
        for _, _, stage in _STAGES:
            for name, conv in getattr(self, stage).items():
                x = torch.relu(conv(x))
                endpoints[f"{stage}/{name}"] = x
            if stage != "conv5":
                x = F.max_pool2d(x, 2, stride=2)  # VALID: floor
                endpoints[f"pool{stage[-1]}"] = x
        endpoints["output"] = x
        return x, endpoints
