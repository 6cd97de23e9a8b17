"""VGG-16 backbone in PyTorch, full and truncated.

Counterpart of ``luminoth_tpu/models/base/vgg.py``: conv1_1 .. conv5_3,
each a 3x3 ``SAME`` conv and a relu, with a 2x2 stride-2 ``VALID`` max-pool
after stages 1-4. At stride 1 a 3x3 ``SAME`` conv pads 1 on every side in
both TF's and flax's convention, so SSD's truncated trunk and Faster
R-CNN's ``vgg_16`` share the convs. At 300x300 the pools give 150, 75, 37
and 18: conv4_3 is 37x37 and conv5_3 18x18 (not the canonical 38/19).

``endpoint`` stops at a named conv (Faster R-CNN's ``conv5/conv5_3``, at
stride 16). The full trunk (``truncated=False`` and no endpoint) goes on
with pool5, ``fc6`` (7x7 ``VALID``), ``fc7`` (1x1) and, with
``num_classes``, ``fc8``.

Modules are NCHW and run on ``torch.channels_last`` tensors. Parameters
stay float32 and are cast to the input's dtype, as in ``resnet.py``.
Module names follow the flax paths: the flax module ``conv1/conv1_1`` is
``conv1.conv1_1`` here, which ``utils/weights.torch_key`` maps back.

Under a spatial grid (``parallel/spatial.py``) the convs and pools up to
``gather_at`` run on this rank's band of the height, their ``SAME``
padding computed from the global height; the map is gathered on the
leader there (Faster R-CNN's endpoint, SSD's first head map ``conv4_3``),
and only the leader goes on.
"""

import torch
import torch.nn.functional as F
from torch import nn

from luminoth_tpu_torch.models.base.resnet import Conv2d
from luminoth_tpu_torch.parallel import spatial

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
    does not pad. ``height``: ``x`` is a band of a map of that global
    height.
    """

    def __init__(self, in_channels, features, kernel_size, stride=1,
                 dilation=1, padding="SAME"):
        super().__init__(in_channels, features, kernel_size, stride=stride,
                         dilation=dilation, bias=True)
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.tf_padding = padding

    def forward(self, x, height=None):
        if height is not None:
            pads = [(0, 0), (0, 0)]
            if self.tf_padding == "SAME":
                pads = [same_padding(size, self.kernel_size[i],
                                     self.stride[i], self.dilation[i])
                        for i, size in enumerate((height, x.shape[3]))]
            return spatial.conv2d(
                x, height, self.weight.to(x.dtype), self.bias.to(x.dtype),
                self.stride[0], self.dilation[0], pads[1] + pads[0])
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
    """VGG-16 trunk with per-layer endpoints: up to conv5_3 (``truncated``)
    or ``endpoint``, else through fc7 (and fc8 with ``num_classes``)."""

    def __init__(self, truncated=True, endpoint=None, num_classes=None):
        super().__init__()
        convs = [(stage, f"{stage}_{i}", features)
                 for reps, features, stage in _STAGES
                 for i in range(1, reps + 1)]
        names = [f"{stage}/{name}" for stage, name, _ in convs]
        if endpoint is not None:
            if endpoint not in names:
                # A typo'd endpoint would silently run the whole trunk at
                # the wrong stride.
                raise ValueError(f"Unknown endpoint {endpoint!r}; expected "
                                 f"one of {sorted(names)}")
            convs = convs[:names.index(endpoint) + 1]
        self.endpoint = endpoint
        # Where a spatial grid gathers the bands (SSD sets conv4_3).
        self.gather_at = names[len(convs) - 1]
        self.full = not truncated and endpoint is None
        in_channels = 3
        for stage, name, features in convs:
            if not hasattr(self, stage):
                self.add_module(stage, nn.ModuleDict())
            getattr(self, stage)[name] = TFConv2d(in_channels, features, 3)
            in_channels = features
        if self.full:
            self.fc6 = TFConv2d(in_channels, 4096, 7, padding="VALID")
            self.fc7 = TFConv2d(4096, 4096, 1)
            in_channels = 4096
            if num_classes:
                self.fc8 = TFConv2d(4096, num_classes, 1)
                in_channels = num_classes
        self.out_channels = in_channels

    def forward(self, x):
        """NCHW ``x`` in the compute dtype → ``(output, endpoints)``;
        endpoints are named as in the JAX package (``conv4/conv4_3``,
        ``pool1``, ..., ``fc7``, ``output``)."""
        endpoints = {}
        band = spatial.current()
        height = None if band is None else band.image_height(x.shape[2])
        for _, _, stage in _STAGES:  # the endpoint returns in its stage
            for name, conv in getattr(self, stage).items():
                x = torch.relu(conv(x, height))
                if height is not None and f"{stage}/{name}" == self.gather_at:
                    x, height = spatial.gather(x, height), None
                    if not band.is_leader:
                        return x, {}
                endpoints[f"{stage}/{name}"] = x
            if f"{stage}/{name}" == self.endpoint:
                return x, endpoints
            if stage != "conv5":
                x = spatial.max_pool2d(x, height, 2, 2)  # VALID: floor
                height = spatial.out_height(height, 2, 2)
                endpoints[f"pool{stage[-1]}"] = x
        if self.full:
            x = F.max_pool2d(x, 2, stride=2)
            x = endpoints["fc6"] = torch.relu(self.fc6(x))
            x = endpoints["fc7"] = torch.relu(self.fc7(x))
            if hasattr(self, "fc8"):
                x = self.fc8(x)
        endpoints["output"] = x
        return x, endpoints
