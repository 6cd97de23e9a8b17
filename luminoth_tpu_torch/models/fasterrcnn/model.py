"""Faster R-CNN in PyTorch.

Counterpart of the JAX package's ``models/fasterrcnn/model.py``: backbone →
anchors → RPN → proposals (NMS, kernel K1; no gradient flows through them)
→ ROI crop+pool (kernel K2 forward, K3 backward) → block4 tail → RCNN head
→ final detections (per-class NMS, kernel K1). Returns the same prediction
dict keys.

With ``gt_boxes`` the RPN and RCNN targets are assigned, and in training
(``model.train()``, the JAX ``train=True``) the ROI stage runs on the fixed
RCNN minibatch only and no detections are made. :meth:`FasterRCNN.loss` is
the 4-part loss. Target subsampling draws from an explicit
``torch.Generator`` (or takes injected ``priorities``).

Under a spatial grid (``parallel/spatial.py``) ``images`` is this rank's
band of the height: the trunk runs on the band and only the leader, which
gathers the map, runs the rest on the whole image; another rank returns
``{"follower": its gathered band}``, whose loss is zero.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from luminoth_tpu_torch.models.base.base_network import (
    BaseNetworkTail,
    TruncatedBaseNetwork,
)
from luminoth_tpu_torch.models.fasterrcnn.rcnn import RCNNHead
from luminoth_tpu_torch.models.fasterrcnn.rcnn_proposal import rcnn_proposal
from luminoth_tpu_torch.models.fasterrcnn.rcnn_target import (
    rcnn_target_assign,
    select_minibatch,
)
from luminoth_tpu_torch.models.fasterrcnn.rpn import RPN
from luminoth_tpu_torch.models.fasterrcnn.rpn_proposal import rpn_proposal
from luminoth_tpu_torch.models.fasterrcnn.rpn_target import (
    draw_priorities,
    rpn_target_assign,
)
from luminoth_tpu_torch.ops.anchors import (
    generate_anchors_grid,
    generate_anchors_reference,
)
from luminoth_tpu_torch.ops.losses import smooth_l1_loss, softmax_cross_entropy
from luminoth_tpu_torch.ops.roi_align import roi_crop_pool_batch
from luminoth_tpu_torch.parallel import spatial
from luminoth_tpu_torch.parallel.mesh import masked_mean
from luminoth_tpu_torch.utils.config import Config


def _gather_rows(values, indices):
    """``values[b, indices[b]]`` for (B, P, ...) values and (B, M) indices."""
    index = indices.reshape(indices.shape + (1,) * (values.dim() - 2))
    return torch.gather(values, 1, index.expand(
        indices.shape + values.shape[2:]))


class FasterRCNN(nn.Module):
    """Two-stage detector with RPN + RCNN over a truncated ResNet or
    VGG-16."""

    def __init__(self, config, dtype=torch.float32):
        super().__init__()
        self.cfg = Config(config)
        model_cfg = self.cfg.model
        self.dtype = dtype
        self.num_classes = int(model_cfg.network.num_classes)
        self.with_rcnn = bool(model_cfg.network.with_rcnn)
        # The keys of loss(return_all=True), in order (a spatial grid's
        # follower reports zeros under them).
        self.loss_names = ("rpn_cls_loss", "rpn_reg_loss") + (
            ("rcnn_cls_loss", "rcnn_reg_loss") if self.with_rcnn else ()) + (
            "total_loss", "no_reg_loss")

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
            in_features = self.base_network_tail.out_channels
            if not model_cfg.rcnn.get("use_mean", True):
                # The flattened (S, S, C) tail output of every ROI.
                roi = model_cfg.rcnn.roi
                in_features *= int(roi.pooled_width) * int(roi.pooled_height)
            self.rcnn = RCNNHead(in_features, self.num_classes,
                                 model_cfg.rcnn, dtype=dtype)

    def _priorities(self, stage, shape, generator, priorities, device):
        """The (fg, bg) subsampling priorities of ``stage`` ("rpn"/"rcnn")."""
        if priorities is not None:
            return tuple(p.to(device) for p in priorities[stage])
        if generator is None:
            # No generator (eval with targets): a fixed draw per stage, like
            # the JAX model's fallback key when it has no "target" rng. It
            # is drawn on the CPU, whose stream differs from CUDA's, so the
            # eval losses do not depend on the device.
            generator = torch.Generator()
            generator.manual_seed(("rpn", "rcnn").index(stage))
            return tuple(p.to(device) for p in
                         draw_priorities(shape, generator, "cpu"))
        return draw_priorities(shape, generator, device)

    def forward(self, images, gt_boxes=None, im_shape=None, generator=None,
                priorities=None):
        """Run the detector.

        Args:
            images: (B, H, W, 3) float images, 0-255 scale, padded to a
                canvas.
            gt_boxes: optional (B, G, 5) padded ground truth (label < 0 on
                padding rows): assigns targets, for :meth:`loss`.
            im_shape: optional (B, 2) actual (height, width) per image;
                defaults to the padded size.
            generator: ``torch.Generator`` on the images' device for the
                target subsampling and dropout draws.
            priorities: optional ``{"rpn": (fg, bg), "rcnn": (fg, bg)}``
                uniform priorities of shapes (B, A) and (B, P) that replace
                the subsampling draws (to reproduce another draw exactly).

        Returns:
            ``{"rpn_prediction": ..., "classification_prediction": ...}``
            with the JAX model's keys.
        """
        model_cfg = self.cfg.model
        batch, full_h, full_w = images.shape[0], images.shape[1], images.shape[2]
        if spatial.current() is not None:  # a band: the canvas's height
            full_h = spatial.current().image_height(full_h)
        if im_shape is None:
            im_shape = torch.tensor(
                [[full_h, full_w]], dtype=torch.float32, device=images.device
            ).expand(batch, 2)
        im_shape = im_shape.float()

        feature_map = self.base_network(images)
        if spatial.is_follower():
            return {"follower": feature_map}
        all_anchors = generate_anchors_grid(
            self.anchor_reference, model_cfg.anchors.stride,
            feature_map.shape[1:3], device=images.device,
        )
        rpn_out = self.rpn(feature_map)

        proposals_cfg = model_cfg.rpn.proposals
        # The proposals carry no gradient (the JAX model stops it there).
        proposal_pred = rpn_proposal(
            rpn_out["rpn_cls_prob"].detach(),
            rpn_out["rpn_bbox_pred"].detach(),
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

        if gt_boxes is not None:
            gt_boxes = gt_boxes.float()
            target_cfg = model_cfg.rpn.target
            (rpn_prediction["rpn_cls_target"],
             rpn_prediction["rpn_bbox_target"],
             rpn_prediction["rpn_max_overlap"]) = rpn_target_assign(
                all_anchors, gt_boxes, im_shape,
                self._priorities("rpn", (batch, all_anchors.shape[0]),
                                 generator, priorities, images.device),
                allowed_border=target_cfg.allowed_border,
                clobber_positives=bool(target_cfg.clobber_positives),
                foreground_threshold=target_cfg.foreground_threshold,
                background_threshold_high=(
                    target_cfg.background_threshold_high),
                foreground_fraction=target_cfg.foreground_fraction,
                minibatch_size=target_cfg.minibatch_size,
            )

        prediction_dict = {"rpn_prediction": rpn_prediction}
        if not self.with_rcnn:
            return prediction_dict

        proposals = proposal_pred["proposals"]
        proposals_valid = proposal_pred["valid"]
        rcnn_cfg = model_cfg.rcnn
        variances = tuple(rcnn_cfg.target_normalization_variances)
        classification = {}

        if gt_boxes is not None:
            t_cfg = rcnn_cfg.target
            proposals_label, bbox_offsets_target = rcnn_target_assign(
                proposals, proposals_valid, gt_boxes,
                self._priorities("rcnn", proposals_valid.shape, generator,
                                 priorities, images.device),
                foreground_threshold=t_cfg.foreground_threshold,
                background_threshold_high=t_cfg.background_threshold_high,
                background_threshold_low=t_cfg.background_threshold_low,
                foreground_fraction=t_cfg.foreground_fraction,
                minibatch_size=t_cfg.minibatch_size,
                variances=variances,
            )
            if self.training:
                # The ROI stage runs on the fixed-size minibatch only.
                sel_idx, proposals_valid = select_minibatch(
                    proposals_label, int(t_cfg.minibatch_size)
                )
                proposals = _gather_rows(proposals, sel_idx)
                proposals_label = _gather_rows(proposals_label, sel_idx)
                bbox_offsets_target = _gather_rows(bbox_offsets_target,
                                                   sel_idx)
            classification["target"] = {
                "cls": proposals_label,
                "bbox_offsets": bbox_offsets_target,
                "selected_mask": proposals_valid,
            }

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
        cls_score, cls_prob, bbox_offsets = self.rcnn(tail_out, generator)
        cls_score = cls_score.reshape(b, r, -1)
        cls_prob = cls_prob.reshape(b, r, -1)
        bbox_offsets = bbox_offsets.reshape(b, r, -1)
        classification.update({
            "rcnn": {
                "cls_score": cls_score,
                "cls_prob": cls_prob,
                "bbox_offsets": bbox_offsets,
            },
            "proposals": proposals,
            "proposals_valid": proposals_valid,
        })
        prediction_dict["classification_prediction"] = classification
        if self.training:
            return prediction_dict

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
        classification.update(detections)
        return prediction_dict

    def loss(self, prediction_dict, return_all=False):
        """The weighted 4-part Faster R-CNN loss (the JAX model's ``loss``).

        Masked means: the RPN classification over non-ignored anchors, the
        RPN regression over positives, the RCNN classification over labeled
        selected proposals and the RCNN regression (the target class's
        deltas) over selected foregrounds. Under data parallelism each
        count is over the global batch (``parallel/mesh.masked_mean``). ``return_all`` returns the parts
        with ``total_loss`` and ``no_reg_loss`` (both the sum; the trainer
        adds the L2 term to ``total_loss``).
        """
        cfg = self.cfg
        if "follower" in prediction_dict:
            return spatial.follower_losses(
                self.loss_names, prediction_dict["follower"], return_all)
        loss_cfg = cfg.model.loss
        rpn_pred = prediction_dict["rpn_prediction"]

        cls_target = rpn_pred["rpn_cls_target"]  # (B, A) in {-1, 0, 1}
        one_hot = F.one_hot(cls_target.clamp(min=0).long(), 2).float()
        ce = softmax_cross_entropy(rpn_pred["rpn_cls_score"], one_hot)
        rpn_cls_loss = masked_mean(ce, cls_target >= 0)
        reg = smooth_l1_loss(
            rpn_pred["rpn_bbox_pred"], rpn_pred["rpn_bbox_target"],
            sigma=cfg.model.rpn.l1_sigma,
        )
        rpn_reg_loss = masked_mean(reg, cls_target == 1)
        losses = {
            "rpn_cls_loss": rpn_cls_loss * loss_cfg.rpn_cls_loss_weight,
            "rpn_reg_loss": rpn_reg_loss * loss_cfg.rpn_reg_loss_weights,
        }

        if self.with_rcnn:
            cls_pred = prediction_dict["classification_prediction"]
            target = cls_pred["target"]
            rcnn = cls_pred["rcnn"]
            rc_target = target["cls"]  # (B, M)
            selected = target["selected_mask"]
            one_hot = F.one_hot(
                rc_target.clamp(min=0).long(), self.num_classes + 1
            ).float()
            ce = softmax_cross_entropy(rcnn["cls_score"], one_hot)
            rcnn_cls_loss = masked_mean(ce, (rc_target >= 0) & selected)

            # The predicted deltas of the target class.
            cls_idx = (rc_target - 1).clamp(min=0).long()
            deltas = rcnn["bbox_offsets"].reshape(
                rc_target.shape + (self.num_classes, 4)
            )
            picked = torch.gather(
                deltas, 2, cls_idx[..., None, None].expand(-1, -1, 1, 4)
            )[..., 0, :]
            reg = smooth_l1_loss(picked, target["bbox_offsets"],
                                 sigma=cfg.model.rcnn.l1_sigma)
            rcnn_reg_loss = masked_mean(reg, (rc_target > 0) & selected)
            losses["rcnn_cls_loss"] = (
                rcnn_cls_loss * loss_cfg.rcnn_cls_loss_weight
            )
            losses["rcnn_reg_loss"] = (
                rcnn_reg_loss * loss_cfg.rcnn_reg_loss_weights
            )

        total = sum(losses.values())
        if return_all:
            losses["total_loss"] = total
            losses["no_reg_loss"] = total
            return {name: losses[name] for name in self.loss_names}
        return total
