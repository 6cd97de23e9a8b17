"""RCNN head: dense stack + classifier/regressor over pooled ROI features.

Counterpart of the JAX package's ``models/fasterrcnn/rcnn.py``: optional
mean-pooling over the crop, then ``layer_sizes`` dense layers with the
configured activation (relu6), then the class scores (C+1) and per-class
box deltas (4·C), both returned in float32. Inference only: dropout
belongs to training, which is not ported yet.
"""

import torch
import torch.nn.functional as F
from torch import nn

from luminoth_tpu_torch.utils.vars import get_activation


class Linear(nn.Linear):
    """``nn.Linear`` computing in the input's dtype from float32 params."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class RCNNHead(nn.Module):
    """Dense layers producing class scores and per-class box deltas."""

    def __init__(self, in_features, num_classes, config,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.use_mean = bool(config.get("use_mean", True))
        self.activation = get_activation(
            config.get("activation_function", "relu6")
        )
        if not self.use_mean:
            raise NotImplementedError(
                "rcnn.use_mean=False is not ported to PyTorch yet"
            )
        self.layer_names = []
        for i, layer_size in enumerate(config.get("layer_sizes") or []):
            self.add_module(f"fc_{i}", Linear(in_features, layer_size))
            self.layer_names.append(f"fc_{i}")
            in_features = layer_size
        self.fc_classifier = Linear(in_features, num_classes + 1)
        self.fc_bbox = Linear(in_features, num_classes * 4)

    def forward(self, roi_features):
        """(N, S, S, C) tail features -> ((N, C+1) scores, probs, (N, 4·C))."""
        net = roi_features.to(self.dtype).mean(dim=(1, 2))
        for name in self.layer_names:
            net = self.activation(getattr(self, name)(net))
        cls_score = self.fc_classifier(net).float()
        bbox_offsets = self.fc_bbox(net).float()
        return cls_score, torch.softmax(cls_score, dim=-1), bbox_offsets
