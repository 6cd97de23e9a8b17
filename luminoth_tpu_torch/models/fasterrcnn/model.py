"""Faster R-CNN inference in PyTorch.

Counterpart of the JAX package's ``models/fasterrcnn/model.py`` for
``train=False`` without ground truth: backbone → anchors → RPN → proposals
(NMS, kernel K1) → ROI crop+pool (kernel K2) → block4 tail → RCNN head →
final detections (per-class NMS, kernel K1). Returns the same prediction
dict keys. Targets and losses come with the training port.
"""

import numpy as np
import torch
from torch import nn

from luminoth_tpu.utils.config import Config
from luminoth_tpu_torch.models.base.base_network import (
    BaseNetworkTail,
    TruncatedBaseNetwork,
)
from luminoth_tpu_torch.models.fasterrcnn.rcnn import RCNNHead
from luminoth_tpu_torch.models.fasterrcnn.rcnn_proposal import rcnn_proposal
from luminoth_tpu_torch.models.fasterrcnn.rpn import RPN
from luminoth_tpu_torch.models.fasterrcnn.rpn_proposal import rpn_proposal
from luminoth_tpu_torch.ops.anchors import (
    generate_anchors_grid,
    generate_anchors_reference,
)
from luminoth_tpu_torch.ops.roi_align import roi_crop_pool_batch


class FasterRCNN(nn.Module):
    """Two-stage detector with RPN + RCNN over a truncated ResNet v1."""

    def __init__(self, config, dtype=torch.float32):
        super().__init__()
        self.cfg = Config(config)
        model_cfg = self.cfg.model
        self.dtype = dtype
        self.num_classes = int(model_cfg.network.num_classes)
        self.with_rcnn = bool(model_cfg.network.with_rcnn)

        anchors_cfg = model_cfg.anchors
        self.anchor_reference = generate_anchors_reference(
            anchors_cfg.base_size,
            np.asarray(anchors_cfg.ratios, dtype=np.float64),
            np.asarray(anchors_cfg.scales, dtype=np.float64),
        )

        self.base_network = TruncatedBaseNetwork(
            model_cfg.base_network, dtype=dtype
        )
        self.rpn = RPN(
            self.base_network.out_channels,
            self.anchor_reference.shape[0],
            model_cfg.rpn,
        )
        if self.with_rcnn:
            self.base_network_tail = BaseNetworkTail(
                model_cfg.base_network, self.base_network.out_channels,
                dtype=dtype,
            )
            self.rcnn = RCNNHead(
                self.base_network_tail.out_channels, self.num_classes,
                model_cfg.rcnn, dtype=dtype,
            )

    def forward(self, images, im_shape=None):
        """Run the detector (inference).

        Args:
            images: (B, H, W, 3) float images, 0-255 scale, padded to a
                canvas.
            im_shape: optional (B, 2) actual (height, width) per image;
                defaults to the padded size.

        Returns:
            ``{"rpn_prediction": ..., "classification_prediction": ...}``
            with the JAX model's keys.
        """
        model_cfg = self.cfg.model
        batch, full_h, full_w = images.shape[0], images.shape[1], images.shape[2]
        if im_shape is None:
            im_shape = torch.tensor(
                [[full_h, full_w]], dtype=torch.float32, device=images.device
            ).expand(batch, 2)
        im_shape = im_shape.float()

        feature_map = self.base_network(images)
        all_anchors = generate_anchors_grid(
            self.anchor_reference, model_cfg.anchors.stride,
            feature_map.shape[1:3], device=images.device,
        )
        rpn_out = self.rpn(feature_map)

        proposals_cfg = model_cfg.rpn.proposals
        proposal_pred = rpn_proposal(
            rpn_out["rpn_cls_prob"],
            rpn_out["rpn_bbox_pred"],
            all_anchors,
            im_shape,
            pre_nms_top_n=proposals_cfg.pre_nms_top_n,
            post_nms_top_n=proposals_cfg.post_nms_top_n,
            nms_threshold=float(proposals_cfg.nms_threshold),
            min_size=proposals_cfg.min_size,
            apply_nms=bool(proposals_cfg.apply_nms),
            clip_after_nms=bool(proposals_cfg.clip_after_nms),
            filter_outside_anchors=bool(proposals_cfg.filter_outside_anchors),
            min_prob_threshold=float(proposals_cfg.min_prob_threshold),
        )

        rpn_prediction = dict(rpn_out)
        rpn_prediction["proposals"] = proposal_pred["proposals"]
        rpn_prediction["scores"] = proposal_pred["scores"]
        rpn_prediction["proposals_valid"] = proposal_pred["valid"]
        prediction_dict = {"rpn_prediction": rpn_prediction}
        if not self.with_rcnn:
            return prediction_dict

        proposals = proposal_pred["proposals"]
        proposals_valid = proposal_pred["valid"]
        rcnn_cfg = model_cfg.rcnn
        variances = tuple(rcnn_cfg.target_normalization_variances)

        # Boxes are normalized by the padded canvas (the frame the feature
        # map covers). pooled_width sets the crop HEIGHT, as in the
        # reference's crop_and_resize call.
        crop_h = int(rcnn_cfg.roi.pooled_width) * 2
        crop_w = int(rcnn_cfg.roi.pooled_height) * 2
        crop_size = crop_h if crop_h == crop_w else (crop_h, crop_w)
        pooled = roi_crop_pool_batch(
            feature_map, proposals, (float(full_h), float(full_w)),
            crop_size=crop_size,
        )  # (B, R, S/2, S/2, C)

        b, r = pooled.shape[0], pooled.shape[1]
        tail_out = self.base_network_tail(pooled.flatten(0, 1))
        cls_score, cls_prob, bbox_offsets = self.rcnn(tail_out)
        cls_score = cls_score.reshape(b, r, -1)
        cls_prob = cls_prob.reshape(b, r, -1)
        bbox_offsets = bbox_offsets.reshape(b, r, -1)

        p_cfg = rcnn_cfg.proposals
        detections = rcnn_proposal(
            proposals,
            bbox_offsets,
            cls_prob,
            proposals_valid,
            im_shape,
            self.num_classes,
            class_max_detections=p_cfg.class_max_detections,
            class_nms_threshold=float(p_cfg.class_nms_threshold),
            total_max_detections=p_cfg.total_max_detections,
            min_prob_threshold=float(p_cfg.min_prob_threshold or 0.0),
            variances=variances,
            pre_nms_max_candidates=int(
                p_cfg.get("pre_nms_max_candidates") or 0
            ),
        )
        classification = {
            "rcnn": {
                "cls_score": cls_score,
                "cls_prob": cls_prob,
                "bbox_offsets": bbox_offsets,
            },
            "proposals": proposals,
            "proposals_valid": proposals_valid,
        }
        classification.update(detections)
        prediction_dict["classification_prediction"] = classification
        return prediction_dict
