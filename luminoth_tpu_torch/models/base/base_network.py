"""Config-driven backbone wrapper (counterpart of the JAX package's
``models/base/base_network.py``).

RGB-mean subtraction comes first, in float32; the trunk stops at the
detection endpoint (``block3`` at output stride 16) and ``block4`` runs
as the ROI tail. The port has the ResNet v1 family; the other
architectures and the int8 serving profiles raise ``NotImplementedError``.

Training keeps batch norm in its inference form (``train_batch_norm:
False``, the detection default): the running statistics stay fixed and
the affine ``weight``/``bias`` train. Updating the statistics
(``train_batch_norm: True``) and rematerialization (``remat``) are not
ported; :func:`check_trainable_config` raises for them.
"""

import torch
from torch import nn

from luminoth_tpu_torch.models.base.resnet import ResNet, ResNetTail

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
}


def subtract_channel_means(images):
    """ImageNet RGB mean subtraction (float32 images, 0-255 range)."""
    means = torch.tensor([_R_MEAN, _G_MEAN, _B_MEAN], dtype=torch.float32,
                         device=images.device)
    return images.float() - means


def _parse_architecture(config):
    """``(depth, endpoint)`` of a ported ResNet v1 config; raises else."""
    architecture = config.get("architecture")
    if architecture not in VALID_ARCHITECTURES:
        raise ValueError('Invalid architecture: "{}"'.format(architecture))
    if not architecture.startswith("resnet_v1"):
        raise NotImplementedError(
            f"{architecture} is not ported to PyTorch yet (ResNet v1 is)"
        )
    for flag in ("torchvision_compat", "int8_trunk", "int8_tail"):
        if config.get(flag):
            raise NotImplementedError(
                f"model.base_network.{flag} is not ported to PyTorch yet"
            )
    depth = int(architecture.rsplit("_", 1)[1])
    endpoint = config.get("endpoint") or DEFAULT_ENDPOINTS[architecture]
    return architecture, depth, endpoint


def check_trainable_config(config):
    """Raise ``NotImplementedError`` for base-network training knobs the port
    does not have (``train_batch_norm``, ``remat``)."""
    for flag in ("train_batch_norm", "remat"):
        if config.get(flag):
            raise NotImplementedError(
                f"model.base_network.{flag} is not ported to PyTorch yet"
            )


class TruncatedBaseNetwork(nn.Module):
    """Backbone truncated at an endpoint, producing the detection map."""

    def __init__(self, config, dtype=torch.float32):
        super().__init__()
        self.architecture, depth, endpoint = _parse_architecture(config)
        self.dtype = dtype
        self.add_module(self.architecture, ResNet(
            depth=depth,
            output_stride=config.get("output_stride"),
            endpoint=endpoint,
        ))

    @property
    def out_channels(self):
        return getattr(self, self.architecture).out_channels

    def forward(self, images):
        """(B, H, W, 3) raw-scale images -> (B, H', W', C) NHWC map."""
        x = subtract_channel_means(images).permute(0, 3, 1, 2)
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        return getattr(self, self.architecture)(x).permute(0, 2, 3, 1)


class BaseNetworkTail(nn.Module):
    """ROI-head trunk: ResNet ``block4`` over pooled ROI crops."""

    def __init__(self, config, depth_in, dtype=torch.float32):
        super().__init__()
        self.use_tail = bool(config.get("use_tail", True))
        self.dtype = dtype
        self.out_channels = depth_in
        if self.use_tail:
            self.architecture, depth, _ = _parse_architecture(config)
            tail = ResNetTail(depth=depth, depth_in=depth_in)
            self.add_module(self.architecture, tail)
            self.out_channels = tail.out_channels

    def forward(self, roi_features):
        """(N, S, S, C) NHWC ROI features -> (N, S, S, C') NHWC."""
        if not self.use_tail:
            return roi_features
        x = roi_features.permute(0, 3, 1, 2)
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        return getattr(self, self.architecture)(x).permute(0, 2, 3, 1)
