"""SSD multi-scale feature extractor: truncated VGG-16 and the extra layers.

Counterpart of ``luminoth_tpu/models/ssd/feature_extractor.py``. Six maps:
conv4_3 L2-normalised with a learned per-channel scale (init 20), conv7
(the dilated conv6 and conv7 that replace VGG's fully connected layers),
and the extras conv8_2 .. conv11_2. At 300x300 they are 37, 18, 9, 5, 3
and 1 on a side.

TF ``SAME`` padding is computed per layer (``vgg.TFConv2d``): conv8_2
takes 18 → 9 with (0, 1) rows and columns, conv9_2 9 → 5 with (1, 1);
conv10_2 and conv11_2 are ``VALID``. pool5 is a 3x3 stride-1 ``SAME``
max-pool, whose padding counts as -inf.

With ``int8_trunk`` (the ``fast`` serving profile) the extractor runs the
int8 twin outside training: ``quantized_extractor.Int8VGG16`` and int8
extras (quant points ``conv6_amax`` .. ``conv11_2_amax`` on this module),
conv4_3's normalisation in float32, every map cast to the model's dtype at
the end. In training the float path runs.

Under a spatial grid (``parallel/spatial.py``) the trunk runs in bands up
to ``conv4_3``, the first head map, where the leader gathers them; the
rest (``conv5``, the dilated ``fc6``/``fc7`` and the extras) runs on the
leader, and the other ranks return their gathered band alone.
"""

import torch
import torch.nn.functional as F
from torch import nn

from luminoth_tpu_torch.models.base.quantized_tail import Int8Points, int8_conv
from luminoth_tpu_torch.models.base.vgg import VGG16, TFConv2d
from luminoth_tpu_torch.models.ssd.quantized_extractor import (
    Int8VGG16,
    _nhwc_pool,
)
from luminoth_tpu_torch.parallel import spatial

# (name, input channels, features, kernel, stride, dilation, padding); a
# feature map is taken after each of conv7 .. conv11_2.
_EXTRAS = (
    ("conv6", 512, 1024, 3, 1, 6, "SAME"),
    ("conv7", 1024, 1024, 1, 1, 1, "SAME"),
    ("conv8_1", 1024, 256, 1, 1, 1, "SAME"),
    ("conv8_2", 256, 512, 3, 2, 1, "SAME"),
    ("conv9_1", 512, 128, 1, 1, 1, "SAME"),
    ("conv9_2", 128, 256, 3, 2, 1, "SAME"),
    ("conv10_1", 256, 128, 1, 1, 1, "SAME"),
    ("conv10_2", 128, 256, 3, 1, 1, "VALID"),
    ("conv11_1", 256, 128, 1, 1, 1, "SAME"),
    ("conv11_2", 128, 256, 3, 1, 1, "VALID"),
)
_MAP_AFTER = ("conv7", "conv8_2", "conv9_2", "conv10_2", "conv11_2")


class L2Normalize(nn.Module):
    """Channel-wise L2 normalisation with a learned (1, 1, 1, C) scale.

    The sum of squares is float32 with 1e-12 inside the square root; the
    result is cast back to the input's dtype.
    """

    def __init__(self, channels, init_scale=20.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((1, 1, 1, channels), init_scale))

    def forward(self, x):
        """NCHW ``x`` → NCHW, normalised over C."""
        x32 = x.float()
        norm = torch.sqrt(torch.sum(torch.square(x32), dim=1, keepdim=True)
                          + 1e-12)
        gamma = self.gamma.reshape(1, -1, 1, 1)
        return (x32 / norm * gamma).to(x.dtype)


class SSDFeatureExtractor(Int8Points, nn.Module):
    """Truncated VGG-16 trunk and SSD's extra feature layers."""

    def __init__(self, config):
        super().__init__()
        architecture = config.get("architecture", "truncated_vgg_16")
        if architecture != "truncated_vgg_16":
            raise ValueError(
                'Invalid SSD architecture "{}"'.format(architecture))
        self.int8 = bool(config.get("int8_trunk"))
        static = self.int8 and bool(config.get("int8_static"))
        self.vgg_16 = (Int8VGG16(static) if self.int8
                       else VGG16(truncated=True))
        self.vgg_16.gather_at = "conv4/conv4_3"
        self._setup_int8([f"{name}_amax" for name, *_ in _EXTRAS]
                         if self.int8 else [], static)
        self.conv4_3_norm = L2Normalize(512)
        for name, cin, cout, kernel, stride, rate, padding in _EXTRAS:
            self.add_module(name, TFConv2d(cin, cout, kernel, stride=stride,
                                           dilation=rate, padding=padding))
        self.out_channels = [512] + [
            cout for name, _, cout, *_ in _EXTRAS if name in _MAP_AFTER]

    def forward(self, x):
        """NCHW mean-subtracted images in the compute dtype → the list of
        six NCHW feature maps (a follower of a spatial grid: its gathered
        band alone)."""
        if self.int8 and not self.training:
            return self._int8_maps(x)
        band, endpoints = self.vgg_16(x)
        if spatial.is_follower():
            return [band]
        feature_maps = [self.conv4_3_norm(endpoints["conv4/conv4_3"])]
        net = F.max_pool2d(endpoints["conv5/conv5_3"], 3, stride=1,
                           padding=1)
        for name, *_ in _EXTRAS:
            net = torch.relu(getattr(self, name)(net))
            if name in _MAP_AFTER:
                feature_maps.append(net)
        return feature_maps

    def _int8_maps(self, x):
        """The int8 recomputation of :meth:`forward`'s float path (the JAX
        ``_int8_maps``): NCHW maps in ``x``'s dtype."""
        conv4_3, net = self.vgg_16.int8_forward(x)
        feature_maps = [self.conv4_3_norm(conv4_3.permute(0, 3, 1, 2))]
        net = _nhwc_pool(net, 3, 1, padding=1)
        for name, *_, padding in _EXTRAS:
            net = int8_conv(self, name, getattr(self, name), net,
                            padding.lower(), f"{name}_amax").relu_()
            if name in _MAP_AFTER:
                feature_maps.append(net.permute(0, 3, 1, 2))
        return [fm.to(x.dtype) for fm in feature_maps]
