"""Int8 twin of SSD's truncated VGG-16 for serving.

Counterpart of the JAX package's ``models/ssd/quantized_extractor.py``:
the same network and parameters as ``models/base/vgg.VGG16``, with
``conv1`` and ``conv2`` in the model's dtype (their bias added in that
dtype after the conv) and ``conv3`` .. ``conv5`` in int8 (per-channel
weights, per-tensor activations, the ``quantized_tail`` primitives).
The extras ``conv6`` .. ``conv11_2`` run int8 in
``feature_extractor.SSDFeatureExtractor``. In training the twin runs the
float path (the flag is inert there).
"""

import torch
import torch.nn.functional as F

from luminoth_tpu_torch.models.base.quantized_tail import Int8Points, int8_conv
from luminoth_tpu_torch.models.base.vgg import _STAGES, VGG16

_FLOAT_STAGES = ("conv1", "conv2")


def _nhwc_pool(x, kernel, stride, padding=0):
    """``F.max_pool2d`` of an NHWC tensor, NHWC out."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride,
                        padding).permute(0, 2, 3, 1)


class Int8VGG16(Int8Points, VGG16):
    """Int8 inference twin of the truncated ``VGG16``; quant points
    ``conv3_1_amax`` .. ``conv5_3_amax`` (each int8 conv's input)."""

    def __init__(self, static_scales=False):
        super().__init__(truncated=True)
        self.int8_convs = [f"{stage}_{i}" for reps, _, stage in _STAGES
                           if stage not in _FLOAT_STAGES
                           for i in range(1, reps + 1)]
        self._setup_int8([f"{name}_amax" for name in self.int8_convs],
                         static_scales)

    def int8_forward(self, x):
        """NCHW ``x`` in the model's dtype → NHWC float32 ``(conv4_3,
        conv5_3)``."""
        conv4_3 = None
        for _, _, stage in _STAGES:
            for name, conv in getattr(self, stage).items():
                if stage in _FLOAT_STAGES:
                    # 3x3 stride 1 SAME pads 1 on every side.
                    x = F.conv2d(x, conv.weight.to(x.dtype), None, 1, 1)
                    x = torch.relu_(x + conv.bias.to(x.dtype).reshape(-1, 1, 1))
                else:
                    x = int8_conv(self, name, conv, x, "same",
                                  f"{name}_amax").relu_()
            if stage == "conv4":
                conv4_3 = x
            if stage in _FLOAT_STAGES:  # NCHW
                x = F.max_pool2d(x, 2, stride=2)
            elif stage != "conv5":  # NHWC
                x = _nhwc_pool(x, 2, 2)
            if stage == _FLOAT_STAGES[-1]:
                x = x.permute(0, 2, 3, 1).contiguous()
        return conv4_3, x
