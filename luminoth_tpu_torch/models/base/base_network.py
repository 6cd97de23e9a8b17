"""Config-driven backbone wrapper (counterpart of the JAX package's
``models/base/base_network.py``).

RGB-mean subtraction comes first, in float32; the trunk stops at the
detection endpoint (``block3`` at output stride 16 for the ResNets,
``conv5/conv5_3`` for VGG-16) and, for a ResNet, ``block4`` runs as the
ROI tail; for VGG-16 the tail is the identity. Every architecture of the
JAX package is here: ResNet v1 and v2 at 50, 101 and 152 layers,
``vgg_16`` and ``truncated_vgg_16``. ``torchvision_compat`` builds the
ResNet with torchvision's stride convention (``resnet.py``).

The int8 serving profiles (``int8_trunk``, ``int8_tail``, with
``int8_static`` for calibrated activation scales) build the twins of
``quantized_tail.py``: the same parameters, int8 outside training and the
float path in it (the flags are inert in training, as in JAX). The twins
are ResNet v1 only: on v2 or VGG-16 the flags build the float modules, as
the JAX package does.

Training keeps batch norm in its inference form by default
(``train_batch_norm: False``, the detection default): the running
statistics stay fixed and the affine ``weight``/``bias`` train. With
``train_batch_norm: True`` every batch norm of the trunk (the frozen units
before ``fine_tune_from`` too, as in JAX) and of the ``block4`` tail
normalises with the batch's statistics while the model trains, and moves
its running statistics. ``remat`` recomputes each trunk unit in the
backward pass (``resnet.remat_unit``). VGG-16 has no batch norm and no
remat, so neither flag changes it, as in JAX.
"""

import torch
from torch import nn

from luminoth_tpu_torch.models.base.quantized_tail import (
    Int8ResNetTail,
    Int8ResNetTrunk,
)
from luminoth_tpu_torch.models.base.resnet import (
    ResNet,
    ResNetTail,
    set_train_batch_norm,
)
from luminoth_tpu_torch.models.base.vgg import VGG16

_R_MEAN = 123.68
_G_MEAN = 116.78
_B_MEAN = 103.94

VALID_ARCHITECTURES = {
    "resnet_v1_50",
    "resnet_v1_101",
    "resnet_v1_152",
    "resnet_v2_50",
    "resnet_v2_101",
    "resnet_v2_152",
    "vgg_16",
    "truncated_vgg_16",
}

DEFAULT_ENDPOINTS = {
    "resnet_v1_50": "block3",
    "resnet_v1_101": "block3",
    "resnet_v1_152": "block3",
    "resnet_v2_50": "block3",
    "resnet_v2_101": "block3",
    "resnet_v2_152": "block3",
    "vgg_16": "conv5/conv5_3",
    "truncated_vgg_16": "conv5/conv5_3",
}


def subtract_channel_means(images):
    """ImageNet RGB mean subtraction (float32 images, 0-255 range)."""
    means = torch.tensor([_R_MEAN, _G_MEAN, _B_MEAN], dtype=torch.float32,
                         device=images.device)
    return images.float() - means


def _parse_architecture(architecture):
    """``(kind, version, depth)``: ``("resnet", 1 or 2, depth)``,
    ``("vgg", None, 16)`` or ``("truncated_vgg", None, 16)``."""
    if architecture not in VALID_ARCHITECTURES:
        raise ValueError('Invalid architecture: "{}"'.format(architecture))
    if architecture.startswith("resnet"):
        version = 1 if architecture.startswith("resnet_v1") else 2
        return "resnet", version, int(architecture.rsplit("_", 1)[1])
    if architecture == "truncated_vgg_16":
        return "truncated_vgg", None, 16
    return "vgg", None, 16


class TruncatedBaseNetwork(nn.Module):
    """Backbone truncated at an endpoint, producing the detection map."""

    def __init__(self, config, dtype=torch.float32):
        super().__init__()
        self.architecture = config.get("architecture")
        kind, version, depth = _parse_architecture(self.architecture)
        endpoint = (config.get("endpoint")
                    or DEFAULT_ENDPOINTS[self.architecture])
        self.dtype = dtype
        self.int8 = bool(config.get("int8_trunk")) and version == 1
        stride_first = bool(config.get("torchvision_compat"))
        if kind != "resnet":
            # The JAX package names the VGG scope ``vgg_16`` for both.
            self.architecture = "vgg_16"
            trunk = VGG16(truncated=kind == "truncated_vgg",
                          endpoint=endpoint if kind == "vgg" else None)
        elif self.int8:
            trunk = Int8ResNetTrunk(
                depth=depth,
                output_stride=config.get("output_stride"),
                endpoint=endpoint,
                stride_first=stride_first,
                static_scales=bool(config.get("int8_static")),
                dtype=dtype,
            )
        else:
            trunk = ResNet(
                depth=depth,
                output_stride=config.get("output_stride"),
                endpoint=endpoint,
                version=version,
                stride_first=stride_first,
            )
        if kind == "resnet":
            trunk.remat = bool(config.get("remat"))
            set_train_batch_norm(trunk, config.get("train_batch_norm"))
        self.add_module(self.architecture, trunk)
        self.is_vgg = kind != "resnet"

    @property
    def out_channels(self):
        return getattr(self, self.architecture).out_channels

    def forward(self, images):
        """(B, H, W, 3) raw-scale images -> (B, H', W', C) NHWC map."""
        x = subtract_channel_means(images).permute(0, 3, 1, 2)
        # the int8 trunk takes the float32 batch (its root conv is float32)
        dtype = torch.float32 if self.int8 and not self.training else (
            self.dtype)
        x = x.to(dtype=dtype, memory_format=torch.channels_last)
        x = getattr(self, self.architecture)(x)
        if self.is_vgg:
            x = x[0]  # (map, endpoints)
        return x.permute(0, 2, 3, 1)


class BaseNetworkTail(nn.Module):
    """ROI-head trunk: ResNet ``block4`` over pooled ROI crops; the
    identity for VGG-16 (and with ``use_tail: False``)."""

    def __init__(self, config, depth_in, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.out_channels = depth_in
        self.architecture = config.get("architecture")
        kind, version, depth = _parse_architecture(self.architecture)
        self.use_tail = bool(config.get("use_tail", True)) and (
            kind == "resnet")
        if self.use_tail:
            if config.get("int8_tail") and version == 1:
                tail = Int8ResNetTail(
                    depth=depth, depth_in=depth_in,
                    static_scales=bool(config.get("int8_static")))
            else:
                tail = ResNetTail(depth=depth, depth_in=depth_in,
                                  version=version)
            set_train_batch_norm(tail, config.get("train_batch_norm"))
            self.add_module(self.architecture, tail)
            self.out_channels = tail.out_channels

    def forward(self, roi_features):
        """(N, S, S, C) NHWC ROI features -> (N, S, S, C') NHWC."""
        if not self.use_tail:
            return roi_features
        x = roi_features.permute(0, 3, 1, 2)
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        return getattr(self, self.architecture)(x).permute(0, 2, 3, 1)
