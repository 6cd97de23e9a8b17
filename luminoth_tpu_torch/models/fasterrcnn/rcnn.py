"""RCNN head: dense stack + classifier/regressor over pooled ROI features.

Counterpart of the JAX package's ``models/fasterrcnn/rcnn.py``: the crop
mean-pooled (``use_mean``, the default) or flattened in (h, w, c) order,
the row order of the flax ``Dense`` kernel, then ``layer_sizes`` dense
layers with the configured activation (relu6), then the class scores
(C+1) and per-class box deltas (4·C), both returned in float32. In
training, dropout with
``dropout_keep_prob < 1`` runs before the first dense layer and after each
hidden one, drawn from an explicit ``torch.Generator`` (flax's
``nn.Dropout``: keep with probability p, scale the kept by 1/p).
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
        """``in_features``: the channels of the tail's output with
        ``use_mean``, else its h·w·c."""
        super().__init__()
        self.dtype = dtype
        self.use_mean = bool(config.get("use_mean", True))
        self.activation = get_activation(
            config.get("activation_function", "relu6")
        )
        self.keep_prob = float(config.get("dropout_keep_prob", 1.0))
        self.layer_names = []
        for i, layer_size in enumerate(config.get("layer_sizes") or []):
            self.add_module(f"fc_{i}", Linear(in_features, layer_size))
            self.layer_names.append(f"fc_{i}")
            in_features = layer_size
        self.fc_classifier = Linear(in_features, num_classes + 1)
        self.fc_bbox = Linear(in_features, num_classes * 4)

    def _dropout(self, net, generator):
        if not self.training or self.keep_prob >= 1.0:
            return net
        keep = torch.rand(net.shape, generator=generator,
                          device=net.device) < self.keep_prob
        return torch.where(keep, net / self.keep_prob, torch.zeros_like(net))

    def forward(self, roi_features, generator=None):
        """(N, S, S, C) tail features -> ((N, C+1) scores, probs, (N, 4·C)).

        ``generator`` draws the dropout masks in training.
        """
        net = roi_features.to(self.dtype)
        # NHWC: reshape flattens in (h, w, c) order, whatever the strides.
        net = (net.mean(dim=(1, 2)) if self.use_mean
               else net.reshape(net.shape[0], -1))
        net = self._dropout(net, generator)
        for name in self.layer_names:
            net = self._dropout(self.activation(getattr(self, name)(net)),
                                generator)
        cls_score = self.fc_classifier(net).float()
        bbox_offsets = self.fc_bbox(net).float()
        return cls_score, torch.softmax(cls_score, dim=-1), bbox_offsets
