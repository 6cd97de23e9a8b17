"""SSD (Single Shot MultiBox Detector) in PyTorch.

Counterpart of the JAX package's ``models/ssd/model.py``: RGB-mean
subtraction → truncated VGG-16 and the extra layers (six maps) → per-map
3x3 MultiBox heads for box offsets and class logits → a float32 softmax.
The anchors are computed once in numpy for the configured fixed input size
and kept as a constant (non-persistent) buffer.

With ``gt_boxes`` the targets are assigned (hard-negative mining included)
for :meth:`SSD.loss`. Outside training (``model.eval()``, the JAX
``train=False``) the detections are made by ``ssd_proposal``, whose grouped
NMS is kernel K1 on CUDA; in training no proposal is made and no kernel
runs. Returns the JAX model's prediction keys.

Under a spatial grid (``parallel/spatial.py``) ``images`` is this rank's
band: the extractor gathers the map at ``conv4_3`` on the leader, which
runs the rest; another rank returns ``{"follower": its gathered band}``,
whose loss is zero.
"""

import numpy as np
import torch
from torch import nn

from luminoth_tpu_torch.models.base.base_network import subtract_channel_means
from luminoth_tpu_torch.models.base.vgg import TFConv2d, same_padding
from luminoth_tpu_torch.models.ssd.anchors import generate_ssd_anchors
from luminoth_tpu_torch.models.ssd.feature_extractor import SSDFeatureExtractor
from luminoth_tpu_torch.models.ssd.proposal import ssd_proposal
from luminoth_tpu_torch.models.ssd.target import ssd_target_assign
from luminoth_tpu_torch.ops.losses import smooth_l1_loss, softmax_cross_entropy
from luminoth_tpu_torch.parallel import spatial
from luminoth_tpu_torch.parallel.mesh import batch_mean
from luminoth_tpu_torch.utils.config import Config


def feature_map_shapes(height, width):
    """The (h, w) of SSD's six maps for a ``height`` x ``width`` input."""
    def side(n):
        for _ in range(3):
            n //= 2  # pool1-pool3, 2x2 VALID
        sides = [n, n // 2]  # conv4_3; pool4, then conv5_3 .. conv7
        for _ in range(2):  # conv8_2, conv9_2: 3x3 stride 2 SAME
            n_in = sides[-1]
            pad = sum(same_padding(n_in, 3, 2))
            sides.append((n_in + pad - 3) // 2 + 1)
        for _ in range(2):  # conv10_2, conv11_2: 3x3 VALID
            sides.append(sides[-1] - 2)
        return sides

    return list(zip(side(height), side(width)))


class SSD(nn.Module):
    """Single-shot detector over a truncated VGG-16."""

    # The keys of loss(return_all=True), in order (a spatial grid's
    # follower reports zeros under them).
    loss_names = ("total_loss", "cls_loss", "bbox_loss")

    def __init__(self, config, dtype=torch.float32):
        super().__init__()
        self.cfg = Config(config)
        model_cfg = self.cfg.model
        self.dtype = dtype
        self.num_classes = int(model_cfg.network.num_classes)
        prep = self.cfg.dataset.image_preprocessing
        self.image_shape = (int(prep.fixed_height), int(prep.fixed_width))
        self.anchors_per_point = [int(a) for a in
                                  model_cfg.anchors.anchors_per_point]

        self.feature_extractor = SSDFeatureExtractor(model_cfg.base_network)
        channels = self.feature_extractor.out_channels
        if len(channels) != len(self.anchors_per_point):
            raise ValueError(
                "anchors_per_point must have one entry per feature map")
        for i, (cin, a) in enumerate(zip(channels, self.anchors_per_point)):
            self.add_module(f"MultiBox_{i}_offsets_conv",
                            TFConv2d(cin, a * 4, 3))
            self.add_module(f"MultiBox_{i}_classes_conv",
                            TFConv2d(cin, a * (self.num_classes + 1), 3))
        self.fm_shapes = feature_map_shapes(*self.image_shape)
        self.register_buffer("anchors", self._anchors(self.fm_shapes),
                             persistent=False)

    def _anchors(self, fm_shapes):
        anchors_cfg = self.cfg.model.anchors
        return torch.from_numpy(generate_ssd_anchors(
            fm_shapes, anchors_cfg.min_scale, anchors_cfg.max_scale,
            np.asarray(anchors_cfg.ratios, dtype=np.float64),
            self.anchors_per_point, self.image_shape,
        ))

    def forward(self, images, gt_boxes=None, im_shape=None, generator=None,
                priorities=None):
        """Run the detector.

        Args:
            images: (B, H, W, 3) float images, 0-255 scale, at the fixed
                input size.
            gt_boxes: optional (B, G, 5) padded ground truth: assigns the
                targets, for :meth:`loss`.
            im_shape, generator, priorities: accepted for the Faster R-CNN
                call signature and unused (the detections clip to the
                fixed input size, and nothing is drawn at random).

        Returns:
            dict with ``cls_pred`` (B, A, C+1) logits, ``loc_pred`` (B, A,
            4), ``anchors`` (A, 4), ``target`` when ``gt_boxes`` is given
            and ``classification_prediction`` outside training.
        """
        del im_shape, generator, priorities
        model_cfg = self.cfg.model
        batch = images.shape[0]
        x = subtract_channel_means(images).permute(0, 3, 1, 2)
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        feature_maps = self.feature_extractor(x)
        if spatial.is_follower():
            return {"follower": feature_maps[0]}

        offsets, scores = [], []
        for i, fm in enumerate(feature_maps):
            for name, out, width in (("offsets", offsets, 4),
                                     ("classes", scores,
                                      self.num_classes + 1)):
                head = getattr(self, f"MultiBox_{i}_{name}_conv")(fm)
                # NHWC order: (h, w, anchor) flattened.
                out.append(head.float().permute(0, 2, 3, 1).reshape(
                    batch, -1, width))
        bbox_offsets = torch.cat(offsets, dim=1)  # (B, A, 4)
        class_scores = torch.cat(scores, dim=1)  # (B, A, C+1)
        class_probabilities = torch.softmax(class_scores, dim=-1)

        fm_shapes = [tuple(fm.shape[2:]) for fm in feature_maps]
        anchors = self.anchors
        if fm_shapes != self.fm_shapes:  # an input off the configured size
            anchors = self._anchors(fm_shapes).to(images.device)

        prediction_dict = {
            "cls_pred": class_scores,
            "loc_pred": bbox_offsets,
            "anchors": anchors,
        }
        variances = tuple(model_cfg.variances)
        if gt_boxes is not None:
            target_cfg = model_cfg.target
            class_targets, bbox_offsets_targets = ssd_target_assign(
                class_probabilities.detach(), anchors, gt_boxes,
                self.num_classes,
                target_cfg.foreground_threshold,
                target_cfg.background_threshold_high,
                target_cfg.hard_negative_ratio,
                variances,
            )
            prediction_dict["target"] = {
                "cls": class_targets,
                "bbox_offsets": bbox_offsets_targets,
            }

        if not self.training:
            p_cfg = model_cfg.proposals
            prediction_dict["classification_prediction"] = ssd_proposal(
                class_probabilities.detach(), bbox_offsets.detach(), anchors,
                self.image_shape, self.num_classes,
                float(p_cfg.class_nms_threshold),
                int(p_cfg.class_max_detections),
                int(p_cfg.total_max_detections),
                float(p_cfg.min_prob_threshold or 0.0),
                variances,
                int(p_cfg.get("pre_nms_max_candidates", 1000)),
            )
        return prediction_dict

    def loss(self, prediction_dict, return_all=False):
        """SSD's multibox loss (the JAX model's ``loss``).

        Per image ``(Σ CE over selected anchors + α·Σ smooth-L1 over
        positives) / num_positives`` (0 without positives), then the mean
        over the batch; ``return_all`` adds the batch means of the two
        sums.
        """
        if "follower" in prediction_dict:
            return spatial.follower_losses(
                self.loss_names, prediction_dict["follower"], return_all)
        num_classes = self.num_classes
        loc_weight = self.cfg.model.loss.localization_loss_weight

        cls_pred = prediction_dict["cls_pred"]
        cls_target = prediction_dict["target"]["cls"]
        loc_pred = prediction_dict["loc_pred"]
        loc_target = prediction_dict["target"]["bbox_offsets"]

        selected = cls_target >= 0
        positive = cls_target > 0
        one_hot = torch.nn.functional.one_hot(
            cls_target.clamp(min=0).long(), num_classes + 1).float()
        ce = softmax_cross_entropy(cls_pred, one_hot)  # (B, A)
        zero = torch.zeros((), device=ce.device)
        cls_loss = torch.sum(torch.where(selected, ce, zero), dim=1)
        reg = smooth_l1_loss(loc_pred, loc_target)
        bbox_loss = torch.sum(torch.where(positive, reg, zero), dim=1)

        num_pos = torch.sum(positive, dim=1).float()
        per_image = torch.where(
            num_pos > 0,
            (cls_loss + bbox_loss * loc_weight) / torch.clamp(num_pos,
                                                              min=1.0),
            zero,
        )
        total_loss = batch_mean(per_image)
        if return_all:
            return dict(zip(self.loss_names, (
                total_loss, batch_mean(cls_loss), batch_mean(bbox_loss))))
        return total_loss
