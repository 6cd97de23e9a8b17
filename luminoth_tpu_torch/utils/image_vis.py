"""Render model internals onto images for TensorBoard summaries.

The port's own copy of the JAX package's ``utils/image_vis.py``: the same
per-model × per-mode registry (``summaries_fn``), the dispatcher
``image_vis_summaries`` and the family of draw functions, each drawing with
PIL on host numpy arrays. Returns ``{name: (H, W, 3) uint8}`` for the
summary writer. The prediction dicts are the models' (``model(...)``
outputs moved to the host with ``.cpu().numpy()``, first image of the
batch); ``tests/test_torch_image_vis.py`` holds every entry pixel-equal to
the JAX function on equal inputs.
"""

import numpy as np
from PIL import Image, ImageDraw

from luminoth_tpu_torch.ops import np_boxes
from luminoth_tpu_torch.vis import build_colormap

FG_COLOR = (44, 160, 44)
BG_COLOR = (214, 39, 40)
PROPOSAL_COLOR = (31, 119, 180)
GT_COLOR = (255, 127, 14)

# Default decode variances when the dispatcher isn't handed the model's
# actual config values (fasterrcnn/base_config.yml
# `rcnn.target_normalization_variances`): RCNN targets and head offsets
# live in variance-normalized space, so debug decodes must divide them
# back out.
RCNN_VARIANCES = (0.1, 0.2)


def _to_pil(image):
    arr = np.clip(np.asarray(image), 0, 255).astype(np.uint8)
    return Image.fromarray(arr).convert("RGB")


def _draw_boxes(draw, boxes, color, width=2, texts=None):
    for i, box in enumerate(np.asarray(boxes)):
        x1, y1, x2, y2 = [float(v) for v in box[:4]]
        if x2 <= x1 or y2 <= y1:
            continue
        for off in range(width):
            draw.rectangle(
                [x1 - off, y1 - off, x2 + off, y2 + off], outline=color
            )
        if texts is not None:
            draw.text((x1 + 2, y1 + 2), str(texts[i]), fill=color)


def draw_gt_boxes(image, gt_boxes=None, **kwargs):
    """Ground-truth boxes with labels."""
    pil = _to_pil(image)
    if gt_boxes is not None and len(gt_boxes):
        gt = np.asarray(gt_boxes)
        valid = gt[:, 4] >= 0
        draw = ImageDraw.Draw(pil)
        _draw_boxes(
            draw, gt[valid], GT_COLOR,
            texts=[int(v) for v in gt[valid][:, 4]],
        )
    return np.asarray(pil)


def draw_rpn_proposals(image, prediction_dict=None, top_k=20, **kwargs):
    """Top-k RPN proposals by score."""
    pil = _to_pil(image)
    rpn = (prediction_dict or {}).get("rpn_prediction", {})
    proposals = rpn.get("proposals")
    if proposals is not None:
        scores = np.asarray(rpn.get("scores"))
        valid = np.asarray(rpn.get("proposals_valid", np.ones_like(scores)))
        proposals = np.asarray(proposals)[valid.astype(bool)]
        scores = scores[valid.astype(bool)]
        order = np.argsort(-scores)[:top_k]
        draw = ImageDraw.Draw(pil)
        _draw_boxes(
            draw, proposals[order], PROPOSAL_COLOR,
            texts=[f"{s:.2f}" for s in scores[order]],
        )
    return np.asarray(pil)


def draw_rpn_targets(image, prediction_dict=None, all_anchors=None, **kwargs):
    """Foreground (green) / background (red) anchor targets."""
    pil = _to_pil(image)
    rpn = (prediction_dict or {}).get("rpn_prediction", {})
    targets = rpn.get("rpn_cls_target")
    if targets is not None and all_anchors is not None:
        targets = np.asarray(targets)
        anchors = np.asarray(all_anchors)
        draw = ImageDraw.Draw(pil)
        _draw_boxes(draw, anchors[targets == 1.0], FG_COLOR, width=1)
        bg = anchors[targets == 0.0]
        if len(bg) > 30:
            bg = bg[np.random.RandomState(0).choice(len(bg), 30,
                                                    replace=False)]
        _draw_boxes(draw, bg, BG_COLOR, width=1)
    return np.asarray(pil)


def draw_object_predictions(image, prediction_dict=None, min_prob=0.0,
                            **kwargs):
    """Final detections with class + probability labels."""
    pil = _to_pil(image)
    cls_pred = (prediction_dict or {}).get("classification_prediction", {})
    objects = cls_pred.get("objects")
    if objects is None:
        cls_pred = prediction_dict or {}
        objects = cls_pred.get("objects")
    if objects is not None:
        objects = np.asarray(objects)
        labels = np.asarray(cls_pred.get("labels"))
        probs = np.asarray(cls_pred.get("probs"))
        valid = np.asarray(
            cls_pred.get("valid", np.ones(len(objects), bool))
        ).astype(bool)
        keep = valid & (probs >= min_prob)
        colormap = build_colormap()
        draw = ImageDraw.Draw(pil)
        for box, label, prob in zip(
            objects[keep], labels[keep], probs[keep]
        ):
            color = colormap(int(label))
            _draw_boxes(
                draw, [box], color, texts=[f"{int(label)} {prob:.2f}"]
            )
    return np.asarray(pil)


def draw_ssd_anchor_matches(image, prediction_dict=None, anchors=None,
                            **kwargs):
    """SSD: anchors labeled foreground by the target stage."""
    pil = _to_pil(image)
    pred = prediction_dict or {}
    target = pred.get("target", {})
    cls = target.get("cls")
    if anchors is None:
        # The SSD model ships its anchors in the prediction dict
        # (models/ssd/model.py); the dispatcher doesn't pass anchors=.
        anchors = pred.get("anchors")
    if cls is not None and anchors is not None:
        cls = np.asarray(cls)
        anchors = np.asarray(anchors)
        draw = ImageDraw.Draw(pil)
        _draw_boxes(draw, anchors[cls > 0], FG_COLOR, width=1)
    return np.asarray(pil)


def draw_top_proposals(image, prediction_dict=None, min_score=0.8,
                       max_display=None, **kwargs):
    """RPN proposals above a score threshold (reference draw_top_proposals;
    its ``max_display`` variant caps how many survivors render)."""
    pil = _to_pil(image)
    rpn = (prediction_dict or {}).get("rpn_prediction", {})
    proposals = rpn.get("proposals")
    if proposals is not None:
        scores = np.asarray(rpn.get("scores"))
        valid = np.asarray(
            rpn.get("proposals_valid", np.ones_like(scores))
        ).astype(bool)
        keep = valid & (scores >= min_score)
        boxes, texts = np.asarray(proposals)[keep], scores[keep]
        if max_display is not None and len(boxes) > max_display:
            order = np.argsort(-texts)[:max_display]
            boxes, texts = boxes[order], texts[order]
        draw = ImageDraw.Draw(pil)
        _draw_boxes(
            draw, boxes, PROPOSAL_COLOR,
            texts=[f"{s:.2f}" for s in texts],
        )
    return np.asarray(pil)


def draw_rcnn_cls_batch(image, prediction_dict=None, gt_boxes=None, **kwargs):
    """RCNN minibatch proposals colored fg/bg with their target labels."""
    pil = _to_pil(image)
    cls_pred = (prediction_dict or {}).get("classification_prediction", {})
    target = cls_pred.get("target", {})
    labels = target.get("cls")
    proposals = cls_pred.get("proposals")
    if labels is not None and proposals is not None:
        labels = np.asarray(labels)
        proposals = np.asarray(proposals)
        mask = np.asarray(
            target.get("selected_mask", np.ones_like(labels))
        ).astype(bool)
        draw = ImageDraw.Draw(pil)
        fg = mask & (labels > 0)
        bg = mask & (labels == 0)
        _draw_boxes(
            draw, proposals[fg], FG_COLOR,
            texts=[int(v) for v in labels[fg]],
        )
        sel = proposals[bg][:20]
        _draw_boxes(draw, sel, BG_COLOR, width=1)
    if gt_boxes is not None and len(gt_boxes):
        gt = np.asarray(gt_boxes)
        draw = ImageDraw.Draw(pil)
        _draw_boxes(draw, gt[gt[:, 4] >= 0], GT_COLOR)
    return np.asarray(pil)


def draw_rpn_bbox_targets(image, prediction_dict=None, all_anchors=None,
                          **kwargs):
    """Foreground anchors with their regression-target boxes (decoded)."""
    pil = _to_pil(image)
    rpn = (prediction_dict or {}).get("rpn_prediction", {})
    targets = rpn.get("rpn_cls_target")
    offsets = rpn.get("rpn_bbox_target")
    if targets is not None and offsets is not None and all_anchors is not None:
        targets = np.asarray(targets)
        fg = targets == 1.0
        anchors = np.asarray(all_anchors)[fg]
        decoded = np_boxes.decode(anchors, np.asarray(offsets)[fg])
        draw = ImageDraw.Draw(pil)
        _draw_boxes(draw, anchors, BG_COLOR, width=1)
        _draw_boxes(draw, decoded, FG_COLOR, width=1)
    return np.asarray(pil)


# ---------------------------------------------------------------------------
# Host-side per-element losses. The models only emit reduced losses (scalar
# means live on device); the debug renderings below need the per-anchor /
# per-proposal values, so they are recomputed here in numpy from the raw
# logits and targets carried in the prediction dict. Semantics follow
# ops/losses.py (CE over non-ignored anchors; smooth-L1 with sigma).
# ---------------------------------------------------------------------------


def _np_softmax_ce(logits, labels):
    """Per-row softmax cross entropy. logits (N, C), labels (N,) int."""
    logits = np.asarray(logits, np.float64)
    shifted = logits - logits.max(axis=-1, keepdims=True)
    logz = np.log(np.exp(shifted).sum(axis=-1))
    n = np.arange(len(labels))
    return logz - shifted[n, np.asarray(labels, np.int64)]


def _np_smooth_l1(pred, target, sigma=3.0):
    """Per-row smooth-L1, summed over the 4 coords (ops/losses.py twin)."""
    d = np.abs(np.asarray(pred, np.float64) - np.asarray(target, np.float64))
    s2 = sigma * sigma
    per = np.where(d < 1.0 / s2, 0.5 * s2 * d * d, d - 0.5 / s2)
    return per.sum(axis=-1)


def _rgba_draw(pil):
    return ImageDraw.Draw(pil, "RGBA")


def _fill_box(draw, box, rgb, fill_alpha=20, outline_alpha=100, text=None,
              text_rgb=None):
    x1, y1, x2, y2 = [float(v) for v in box[:4]]
    if x2 <= x1 or y2 <= y1:
        return
    draw.rectangle(
        [x1, y1, x2, y2], fill=rgb + (fill_alpha,),
        outline=rgb + (outline_alpha,),
    )
    if text is not None:
        draw.text(
            (max(x1, 0) + 1, max(y1, 0) + 1), str(text),
            fill=(text_rgb or rgb) + (255,),
        )


def _corner_lines(draw, a, b):
    """Thin lines joining the corners of box a to box b (reference's
    anchor→prediction correspondence rendering)."""
    ax1, ay1, ax2, ay2 = [float(v) for v in a[:4]]
    bx1, by1, bx2, by2 = [float(v) for v in b[:4]]
    for pa, pb in (((ax1, ay1), (bx1, by1)), ((ax2, ay1), (bx2, by1)),
                   ((ax2, ay2), (bx2, by2)), ((ax1, ay2), (bx1, by2))):
        draw.line([pa, pb], fill=(0, 0, 0, 170), width=1)


def _overlay_gt(draw, gt_boxes, with_labels=False):
    if gt_boxes is None or not len(gt_boxes):
        return
    gt = np.asarray(gt_boxes)
    for row in gt[gt[:, 4] >= 0]:
        _fill_box(
            draw, row, (0, 0, 255), fill_alpha=50, outline_alpha=150,
            text=int(row[4]) if with_labels else None,
        )


def _rpn_batch_arrays(prediction_dict, all_anchors):
    """(targets, anchors, score2, bbox_pred, bbox_target, max_overlap) or
    None when the training-only target keys are absent."""
    rpn = (prediction_dict or {}).get("rpn_prediction", {})
    targets = rpn.get("rpn_cls_target")
    if targets is None or all_anchors is None:
        return None
    return (
        np.asarray(targets),
        np.asarray(all_anchors),
        np.asarray(rpn.get("rpn_cls_score")),
        np.asarray(rpn.get("rpn_bbox_pred")),
        np.asarray(rpn.get("rpn_bbox_target")),
        np.asarray(rpn.get("rpn_max_overlap", np.zeros(len(targets)))),
    )


def draw_positive_anchors(image, prediction_dict=None, gt_boxes=None,
                          all_anchors=None, **kwargs):
    """Foreground anchors annotated with their max IoU against GT
    (reference draw_positive_anchors)."""
    pil = _to_pil(image)
    arrays = _rpn_batch_arrays(prediction_dict, all_anchors)
    if arrays is not None:
        targets, anchors, _, _, _, overlap = arrays
        draw = _rgba_draw(pil)
        for anchor, iou in zip(anchors[targets == 1], overlap[targets == 1]):
            _fill_box(draw, anchor, (0, 255, 0), fill_alpha=40,
                      text=f"{iou:.2f}")
        _overlay_gt(draw, gt_boxes)
    return np.asarray(pil)


def draw_anchor_centers(image, all_anchors=None, **kwargs):
    """3x3 dots at every anchor center (reference draw_anchor_centers)."""
    pil = _to_pil(image)
    if all_anchors is not None:
        anchors = np.asarray(all_anchors)
        cx = (anchors[:, 0] + anchors[:, 2]) / 2.0
        cy = (anchors[:, 1] + anchors[:, 3]) / 2.0
        draw = _rgba_draw(pil)
        for x, y in zip(cx, cy):
            draw.rectangle([x - 1, y - 1, x + 1, y + 1],
                           fill=(255, 0, 0, 150), outline=(0, 255, 0, 200))
    return np.asarray(pil)


def draw_anchors(image, all_anchors=None, anchor_num=None,
                 anchors_per_point=None, **kwargs):
    """All anchors (or one anchor-reference index per location) on a canvas
    expanded so out-of-image anchors stay visible (reference draw_anchors)."""
    pil = _to_pil(image)
    if all_anchors is None:
        return np.asarray(pil)
    anchors = np.asarray(all_anchors, np.float64)
    if anchor_num is not None:
        k = anchors_per_point or 9  # scales x ratios at the defaults
        anchors = anchors[anchor_num::k]
    off_x = max(0.0, -anchors[:, 0].min())
    off_y = max(0.0, -anchors[:, 1].min())
    moved = anchors + np.array([[off_x, off_y, off_x, off_y]])
    back = Image.new(
        "RGB",
        [int(max(moved[:, 2].max(), pil.width + off_x)) + 1,
         int(max(moved[:, 3].max(), pil.height + off_y)) + 1],
        "white",
    )
    back.paste(pil, (int(off_x), int(off_y)))
    draw = _rgba_draw(back)
    alpha = 2 if anchor_num is None else 6
    for box in moved:
        draw.rectangle(list(box), fill=(255, 0, 0, max(1, alpha // 2)),
                       outline=(0, 255, 0, alpha))
    return np.asarray(back)


def draw_anchor_batch(image, prediction_dict=None, all_anchors=None,
                      **kwargs):
    """Every anchor selected into the RPN minibatch, translucent green for
    foreground / magenta for background (reference draw_anchor_batch)."""
    pil = _to_pil(image)
    arrays = _rpn_batch_arrays(prediction_dict, all_anchors)
    if arrays is not None:
        targets, anchors = arrays[0], arrays[1]
        draw = _rgba_draw(pil)
        for anchor, t in zip(anchors[targets >= 0], targets[targets >= 0]):
            rgb = (20, 200, 10) if t == 1 else (200, 10, 170)
            _fill_box(draw, anchor, rgb, fill_alpha=15, outline_alpha=30)
    return np.asarray(pil)


def draw_batch_proposals(image, prediction_dict=None, gt_boxes=None,
                         all_anchors=None, display="proposal", top_k=None,
                         draw_all=True, **kwargs):
    """RPN minibatch members as anchors or decoded proposals, colored by
    target with the objectness score as text (reference
    draw_batch_proposals)."""
    pil = _to_pil(image)
    arrays = _rpn_batch_arrays(prediction_dict, all_anchors)
    if arrays is None:
        return np.asarray(pil)
    targets, anchors, cls_score, bbox_pred = arrays[:4]
    rpn = prediction_dict["rpn_prediction"]
    scores = np.asarray(rpn.get("rpn_cls_prob"))[:, 1]

    keep = targets >= 0
    if not draw_all:
        keep = targets > 0
    idx = np.nonzero(keep)[0]
    if top_k:
        idx = idx[np.argsort(-scores[idx])[:top_k]]

    boxes = np_boxes.decode(anchors[idx], bbox_pred[idx]) \
        if display == "proposal" else anchors[idx]
    draw = _rgba_draw(pil)
    for box, t, score in zip(boxes, targets[idx], scores[idx]):
        rgb = (0, 0, 255) if t == 1 else (255, 0, 0)
        outline = (0, 0, 255) if score > 0.5 else (255, 0, 0)
        x1, y1, x2, y2 = [float(v) for v in box[:4]]
        if x2 <= x1 or y2 <= y1:
            continue
        draw.rectangle([x1, y1, x2, y2],
                       fill=rgb + (30 if t == 1 else 5,),
                       outline=outline + (50,))
        draw.text((max(x1, 0), max(y1, 0)), f"{score:.2f}",
                  fill=rgb + (160,))
    _overlay_gt(draw, gt_boxes)
    return np.asarray(pil)


def draw_top_nms_proposals(image, prediction_dict=None, gt_boxes=None,
                           min_score=0.8, draw_gt=False, **kwargs):
    """Post-NMS RPN proposals above min_score, fill fading with rank
    (reference draw_top_nms_proposals)."""
    pil = _to_pil(image)
    rpn = (prediction_dict or {}).get("rpn_prediction", {})
    proposals = rpn.get("proposals")
    if proposals is not None:
        scores = np.asarray(rpn.get("scores"))
        valid = np.asarray(
            rpn.get("proposals_valid", np.ones_like(scores))
        ).astype(bool)
        keep = valid & (scores > min_score)
        proposals = np.asarray(proposals)[keep]
        scores = scores[keep]
        order = np.argsort(-scores)
        draw = _rgba_draw(pil)
        alpha = 70
        for box, score in zip(proposals[order], scores[order]):
            _fill_box(draw, box, (0, 255, 0), fill_alpha=max(alpha, 0),
                      outline_alpha=50, text=f"{score:.2f}")
            alpha -= 5
        if draw_gt:
            _overlay_gt(draw, gt_boxes)
    return np.asarray(pil)


def draw_rpn_cls_loss(image, prediction_dict=None, gt_boxes=None,
                      all_anchors=None, foreground=True, topn=10, worst=True,
                      **kwargs):
    """Top-n best/worst anchors by per-anchor RPN cross entropy, fg or bg
    (reference draw_rpn_cls_loss). Loss recomputed host-side."""
    pil = _to_pil(image)
    arrays = _rpn_batch_arrays(prediction_dict, all_anchors)
    if arrays is None:
        return np.asarray(pil)
    targets, anchors, cls_score = arrays[:3]
    sel = targets == (1 if foreground else 0)
    ce = _np_softmax_ce(cls_score[sel], targets[sel].astype(np.int64))
    order = np.argsort(-ce if worst else ce)[:topn]
    draw = _rgba_draw(pil)
    for anchor, loss in zip(anchors[sel][order], ce[order]):
        _fill_box(draw, anchor, (0, 255, 0), text=f"{loss:.2f}",
                  text_rgb=(0, 0, 0))
    _overlay_gt(draw, gt_boxes)
    return np.asarray(pil)


def draw_rpn_pred_combined_loss(image, prediction_dict=None,
                                all_anchors=None, top_k=10, **kwargs):
    """Decoded foreground predictions annotated with CE + smooth-L1 combined
    per-anchor loss (reference draw_rpn_pred_combined_loss)."""
    pil = _to_pil(image)
    arrays = _rpn_batch_arrays(prediction_dict, all_anchors)
    if arrays is None:
        return np.asarray(pil)
    targets, anchors, cls_score, bbox_pred, bbox_target, _ = arrays
    fg = targets == 1
    if not fg.any():
        return np.asarray(pil)
    ce = _np_softmax_ce(cls_score[fg], targets[fg].astype(np.int64))
    reg = _np_smooth_l1(bbox_pred[fg], bbox_target[fg])
    combined = ce + reg
    order = np.argsort(-combined)[:top_k]
    boxes = np_boxes.decode(anchors[fg][order], bbox_pred[fg][order])
    draw = _rgba_draw(pil)
    for box, loss in zip(boxes, combined[order]):
        _fill_box(draw, box, (30, 0, 240), text=f"{loss:.2f}",
                  text_rgb=(0, 0, 0))
    return np.asarray(pil)


def draw_rpn_bbox_pred(image, prediction_dict=None, all_anchors=None,
                       top_k=5, **kwargs):
    """Top-k foreground anchors by regression loss: anchor (green), decoded
    prediction (magenta), corner lines (reference draw_rpn_bbox_pred)."""
    pil = _to_pil(image)
    arrays = _rpn_batch_arrays(prediction_dict, all_anchors)
    if arrays is None:
        return np.asarray(pil)
    targets, anchors, _, bbox_pred, bbox_target, _ = arrays
    fg = targets == 1
    if not fg.any():
        return np.asarray(pil)
    reg = _np_smooth_l1(bbox_pred[fg], bbox_target[fg])
    order = np.argsort(-reg)[:top_k]
    sel_anchors = anchors[fg][order]
    boxes = np_boxes.decode(sel_anchors, bbox_pred[fg][order])
    draw = _rgba_draw(pil)
    for anchor, box, loss in zip(sel_anchors, boxes, reg[order]):
        _fill_box(draw, anchor, (0, 255, 0), text=f"{loss:.2f}",
                  text_rgb=(0, 0, 0))
        _fill_box(draw, box, (255, 0, 255))
        _corner_lines(draw, anchor, box)
    return np.asarray(pil)


def draw_rpn_bbox_pred_with_target(image, prediction_dict=None,
                                   all_anchors=None, worst=True, **kwargs):
    """Single best/worst foreground anchor: anchor (green), prediction
    (magenta), decoded target (red) (reference
    draw_rpn_bbox_pred_with_target)."""
    pil = _to_pil(image)
    arrays = _rpn_batch_arrays(prediction_dict, all_anchors)
    if arrays is None:
        return np.asarray(pil)
    targets, anchors, _, bbox_pred, bbox_target, _ = arrays
    fg = targets == 1
    if not fg.any():
        return np.asarray(pil)
    reg = _np_smooth_l1(bbox_pred[fg], bbox_target[fg])
    i = int(np.argmax(reg) if worst else np.argmin(reg))
    anchor = anchors[fg][i]
    pred = np_boxes.decode(anchor[None], bbox_pred[fg][i][None])[0]
    tgt = np_boxes.decode(anchor[None], bbox_target[fg][i][None])[0]
    draw = _rgba_draw(pil)
    _fill_box(draw, anchor, (0, 255, 0))
    _fill_box(draw, pred, (255, 0, 255))
    _fill_box(draw, tgt, (255, 0, 0))
    return np.asarray(pil)


def _rcnn_batch_arrays(prediction_dict):
    """Selected RCNN minibatch (proposals, cls targets, offsets targets,
    head logits, head offsets) or None outside training."""
    cls_pred = (prediction_dict or {}).get("classification_prediction", {})
    target = cls_pred.get("target", {})
    labels = target.get("cls")
    proposals = cls_pred.get("proposals")
    if labels is None or proposals is None:
        return None
    labels = np.asarray(labels)
    mask = np.asarray(
        target.get("selected_mask", np.ones_like(labels))
    ).astype(bool) & (labels >= 0)
    rcnn = cls_pred.get("rcnn", {})
    return (
        np.asarray(proposals)[mask],
        labels[mask],
        np.asarray(target.get("bbox_offsets"))[mask],
        np.asarray(rcnn.get("cls_score"))[mask]
        if rcnn.get("cls_score") is not None else None,
        np.asarray(rcnn.get("bbox_offsets"))[mask]
        if rcnn.get("bbox_offsets") is not None else None,
    )


def draw_rcnn_cls_batch_errors(image, prediction_dict=None, gt_boxes=None,
                               worst=True, n=10, **kwargs):
    """Best/worst-n RCNN minibatch proposals by classification CE, drawn at
    their target boxes (reference draw_rcnn_cls_batch_errors)."""
    pil = _to_pil(image)
    arrays = _rcnn_batch_arrays(prediction_dict)
    if arrays is None or arrays[3] is None:
        return np.asarray(pil)
    proposals, labels, offsets_target, cls_score, _ = arrays
    ce = _np_softmax_ce(cls_score, labels.astype(np.int64))
    order = np.argsort(-ce if worst else ce)[:n]
    boxes = np_boxes.decode(
        proposals[order], offsets_target[order],
        variances=kwargs.get("variances") or RCNN_VARIANCES,
    )
    draw = _rgba_draw(pil)
    for box, t, err in zip(boxes, labels[order], ce[order]):
        rgb = (0, 255, 0) if t > 0 else (255, 0, 0)
        _fill_box(draw, box, rgb, text=f"{err:.2f}")
    _overlay_gt(draw, gt_boxes)
    return np.asarray(pil)


def draw_rcnn_reg_batch_errors(image, prediction_dict=None, gt_boxes=None,
                               l1_sigma=1.0, **kwargs):
    """Foreground RCNN minibatch: proposal (yellow), decoded per-class
    prediction (green), 'r<reg> - c<cls>' loss text, corner lines
    (reference draw_rcnn_reg_batch_errors)."""
    pil = _to_pil(image)
    arrays = _rcnn_batch_arrays(prediction_dict)
    if arrays is None or arrays[3] is None or arrays[4] is None:
        return np.asarray(pil)
    proposals, labels, offsets_target, cls_score, head_offsets = arrays
    fg = labels > 0
    if not fg.any():
        return np.asarray(pil)
    proposals, labels = proposals[fg], labels[fg]
    offsets_target = offsets_target[fg]
    ce = _np_softmax_ce(cls_score[fg], labels.astype(np.int64))
    # Pick the 4 offsets of each proposal's target class.
    per_class = head_offsets[fg].reshape(len(labels), -1, 4)
    picked = per_class[np.arange(len(labels)), labels.astype(np.int64) - 1]
    reg = _np_smooth_l1(picked, offsets_target, sigma=l1_sigma)
    boxes = np_boxes.decode(
        proposals, picked,
        variances=kwargs.get("variances") or RCNN_VARIANCES,
    )
    draw = _rgba_draw(pil)
    for prop, box, r, c in zip(proposals, boxes, reg, ce):
        _fill_box(draw, box, (0, 255, 0),
                  text=f"r{r:.3f} - c{c:.2f}", text_rgb=(0, 0, 0))
        _fill_box(draw, prop, (255, 255, 30))
        _corner_lines(draw, prop, box)
    _overlay_gt(draw, gt_boxes)
    return np.asarray(pil)


def draw_correct_rpn_proposals_anchors(image, prediction_dict=None,
                                       gt_boxes=None, all_anchors=None,
                                       top_k=5, **kwargs):
    """Top-k decoded RPN regressions by IoU with GT, with source anchors
    (reference draw_correct_rpn_proposals_anchors)."""
    pil = _to_pil(image)
    rpn = (prediction_dict or {}).get("rpn_prediction", {})
    bbox_pred = rpn.get("rpn_bbox_pred")
    if bbox_pred is None or all_anchors is None or gt_boxes is None \
            or not len(gt_boxes):
        return np.asarray(pil)
    anchors = np.asarray(all_anchors)
    scores = np.asarray(rpn.get("rpn_cls_prob"))[:, 1]
    boxes = np_boxes.decode(anchors, np.asarray(bbox_pred))
    gt = np.asarray(gt_boxes)
    gt = gt[gt[:, 4] >= 0]
    iou = np_boxes.bbox_overlap(boxes, gt[:, :4]).max(axis=1)
    order = np.argsort(-iou)[:top_k]
    draw = _rgba_draw(pil)
    for box, anchor, score in zip(boxes[order], anchors[order],
                                  scores[order]):
        _fill_box(draw, box, (0, 255, 50), text=f"{score:.2f}",
                  text_rgb=(0, 0, 0))
        _fill_box(draw, anchor, (0, 50, 255))
    return np.asarray(pil)


def draw_rpn_correct_proposals(image, prediction_dict=None, gt_boxes=None,
                               min_iou=0.95, **kwargs):
    """Post-NMS proposals nearly coincident with a GT box (IoU >= 0.95)
    (reference draw_rpn_correct_proposals)."""
    pil = _to_pil(image)
    rpn = (prediction_dict or {}).get("rpn_prediction", {})
    proposals = rpn.get("proposals")
    if proposals is None or gt_boxes is None or not len(gt_boxes):
        return np.asarray(pil)
    proposals = np.asarray(proposals)
    valid = np.asarray(
        rpn.get("proposals_valid", np.ones(len(proposals)))
    ).astype(bool)
    gt = np.asarray(gt_boxes)
    gt = gt[gt[:, 4] >= 0]
    iou = np_boxes.bbox_overlap(proposals, gt[:, :4]).max(axis=1)
    draw = _rgba_draw(pil)
    for box in proposals[valid & (iou >= min_iou)]:
        _fill_box(draw, box, (0, 255, 50))
    return np.asarray(pil)


def draw_rcnn_input_proposals(image, prediction_dict=None, gt_boxes=None,
                              **kwargs):
    """Proposals entering the RCNN head with IoU >= 0.5 against GT, IoU as
    text (reference draw_rcnn_input_proposals)."""
    pil = _to_pil(image)
    rpn = (prediction_dict or {}).get("rpn_prediction", {})
    proposals = rpn.get("proposals")
    if proposals is None or gt_boxes is None or not len(gt_boxes):
        return np.asarray(pil)
    proposals = np.asarray(proposals)
    valid = np.asarray(
        rpn.get("proposals_valid", np.ones(len(proposals)))
    ).astype(bool)
    gt = np.asarray(gt_boxes)
    gt = gt[gt[:, 4] >= 0]
    iou = np_boxes.bbox_overlap(proposals, gt[:, :4]).max(axis=1)
    keep = valid & (iou >= 0.5)
    draw = _rgba_draw(pil)
    for box, ov in zip(proposals[keep], iou[keep]):
        _fill_box(draw, box, (0, 255, 0), text=f"{ov:.2f}",
                  text_rgb=(0, 0, 0))
    return np.asarray(pil)


# --- SSD debug renderings --------------------------------------------------

# Config defaults, used when the dispatcher isn't handed the model's
# actual values (image_vis_summaries/variances plumbs the overrides):
# models/ssd/base_config.yml `variances`, fasterrcnn/base_config.yml
# `rcnn.target_normalization_variances`.
SSD_VARIANCES = (0.1, 0.2)


def draw_ssd_target_proposals(image, prediction_dict=None, gt_boxes=None,
                              **kwargs):
    """Decoded SSD localization predictions colored by target class
    (reference draw_ssd_target_proposals)."""
    pil = _to_pil(image)
    pred = prediction_dict or {}
    target = pred.get("target", {})
    cls = target.get("cls")
    anchors = pred.get("anchors")
    loc = pred.get("loc_pred")
    if cls is None or anchors is None or loc is None:
        return np.asarray(pil)
    cls = np.asarray(cls)
    sel = cls >= 0
    boxes = np_boxes.decode(
        np.asarray(anchors)[sel], np.asarray(loc)[sel],
        variances=kwargs.get("variances") or SSD_VARIANCES,
    )
    draw = _rgba_draw(pil)
    alpha = 70
    for box, t in zip(boxes, cls[sel]):
        rgb = (0, 255, 0) if t > 0 else (255, 0, 0)
        _fill_box(draw, box, rgb, fill_alpha=max(alpha, 0))
        alpha -= 5
    _overlay_gt(draw, gt_boxes)
    return np.asarray(pil)


def draw_ssd_cls_loss(image, prediction_dict=None, gt_boxes=None,
                      foreground=True, topn=10, worst=True, **kwargs):
    """Top-n best/worst SSD anchors by per-anchor CE, fg or bg (reference
    draw_ssd_cls_loss). Loss recomputed host-side from cls_pred logits."""
    pil = _to_pil(image)
    pred = prediction_dict or {}
    target = pred.get("target", {})
    cls = target.get("cls")
    anchors = pred.get("anchors")
    logits = pred.get("cls_pred")
    if cls is None or anchors is None or logits is None:
        return np.asarray(pil)
    cls = np.asarray(cls)
    sel = (cls > 0) if foreground else (cls == 0)
    if not sel.any():
        return np.asarray(pil)
    ce = _np_softmax_ce(np.asarray(logits)[sel], cls[sel].astype(np.int64))
    order = np.argsort(-ce if worst else ce)[:topn]
    draw = _rgba_draw(pil)
    for anchor, loss in zip(np.asarray(anchors)[sel][order], ce[order]):
        _fill_box(draw, anchor, (0, 255, 0), text=f"{loss:.2f}",
                  text_rgb=(0, 0, 0))
    _overlay_gt(draw, gt_boxes)
    return np.asarray(pil)


def draw_ssd_bbox_pred(image, prediction_dict=None, top_k=5, **kwargs):
    """Top-k foreground SSD anchors by localization loss: anchor, decoded
    prediction, corner lines (reference draw_ssd_bbox_pred)."""
    pil = _to_pil(image)
    pred = prediction_dict or {}
    target = pred.get("target", {})
    cls = target.get("cls")
    offsets_target = target.get("bbox_offsets")
    anchors = pred.get("anchors")
    loc = pred.get("loc_pred")
    if cls is None or offsets_target is None or anchors is None \
            or loc is None:
        return np.asarray(pil)
    cls = np.asarray(cls)
    fg = cls > 0
    if not fg.any():
        return np.asarray(pil)
    loc, anchors = np.asarray(loc)[fg], np.asarray(anchors)[fg]
    reg = _np_smooth_l1(loc, np.asarray(offsets_target)[fg])
    order = np.argsort(-reg)[:top_k]
    boxes = np_boxes.decode(
        anchors[order], loc[order],
        variances=kwargs.get("variances") or SSD_VARIANCES,
    )
    draw = _rgba_draw(pil)
    for anchor, box, loss in zip(anchors[order], boxes, reg[order]):
        _fill_box(draw, anchor, (0, 255, 0), text=f"{loss:.2f}",
                  text_rgb=(0, 0, 0))
        _fill_box(draw, box, (255, 0, 255))
        _corner_lines(draw, anchor, box)
    return np.asarray(pil)


def draw_ssd_final_pred_anchors(image, prediction_dict=None, **kwargs):
    """Final SSD detections joined to their best-IoU source anchors
    (reference draw_ssd_final_pred_anchors; the source anchor is recovered
    host-side by IoU since the proposal stage emits only boxes)."""
    pil = _to_pil(image)
    pred = prediction_dict or {}
    cls_pred = pred.get("classification_prediction", {})
    objects = cls_pred.get("objects")
    anchors = pred.get("anchors")
    if objects is None or anchors is None:
        return np.asarray(pil)
    objects = np.asarray(objects)
    labels = np.asarray(cls_pred.get("labels"))
    probs = np.asarray(cls_pred.get("probs"))
    valid = np.asarray(
        cls_pred.get("valid", np.ones(len(objects)))
    ).astype(bool)
    if not valid.any():
        return np.asarray(pil)
    objects, labels, probs = objects[valid], labels[valid], probs[valid]
    anchors = np.asarray(anchors)
    src = anchors[np_boxes.bbox_overlap(objects, anchors).argmax(axis=1)]
    draw = _rgba_draw(pil)
    for box, anchor, label, prob in zip(objects, src, labels, probs):
        _fill_box(draw, anchor, (0, 255, 0))
        _fill_box(draw, box, (255, 0, 255),
                  text=f"{int(label)} - {prob:.2f}", text_rgb=(0, 0, 0))
        _corner_lines(draw, anchor, box)
    return np.asarray(pil)


def draw_ssd_top_k_anchors_per_gt(image, prediction_dict=None, gt_boxes=None,
                                  top_k=5, **kwargs):
    """For each GT box, its top-k anchors by IoU, green above 0.5 / red
    below (reference draw_ssd_top_k_anchors_per_gt)."""
    pil = _to_pil(image)
    anchors = (prediction_dict or {}).get("anchors")
    if anchors is None or gt_boxes is None or not len(gt_boxes):
        return np.asarray(pil)
    anchors = np.asarray(anchors)
    gt = np.asarray(gt_boxes)
    gt = gt[gt[:, 4] >= 0]
    if not len(gt):
        return np.asarray(pil)
    overlaps = np_boxes.bbox_overlap(anchors, gt[:, :4])
    draw = _rgba_draw(pil)
    for col, gt_box in zip(overlaps.T, gt):
        _fill_box(draw, gt_box, (0, 0, 255), fill_alpha=50,
                  outline_alpha=150)
        idx = np.argsort(-col)[:top_k]
        for anchor, iou in zip(anchors[idx], col[idx]):
            rgb = (0, 255, 0) if iou > 0.5 else (255, 0, 0)
            _fill_box(draw, anchor, rgb, fill_alpha=0, text=f"{iou:.2f}")
    return np.asarray(pil)


def _with_kwargs(fn, **fixed):
    """Registry entry: a draw function with preset kwargs and a
    distinguishing summary name (reference's parametrized summaries_fn
    entries, image_vis.py:44-116)."""
    import functools

    wrapped = functools.partial(fn, **fixed)
    suffix = "_".join(f"{k}_{v}" for k, v in fixed.items())
    wrapped.__name__ = f"{fn.__name__}/{suffix}" if suffix else fn.__name__
    return wrapped


# Per-model × per-mode registry (reference image_vis.py:21-116).
summaries_fn = {
    "fasterrcnn": {
        "train": [draw_gt_boxes, draw_top_nms_proposals,
                  draw_object_predictions],
        "eval": [draw_gt_boxes, draw_top_nms_proposals,
                 draw_object_predictions],
        "debug": [
            draw_gt_boxes,
            draw_anchors,
            _with_kwargs(draw_anchors, anchor_num=0),
            draw_anchor_centers,
            draw_anchor_batch,
            draw_positive_anchors,
            draw_rpn_proposals,
            # Parameter-variant sets mirror the reference's debug
            # registry (image_vis.py:43-88) entry for entry.
            draw_top_proposals,
            _with_kwargs(draw_top_proposals, min_score=0.0),
            _with_kwargs(draw_top_proposals, max_display=50),
            draw_top_nms_proposals,
            _with_kwargs(draw_top_nms_proposals, min_score=0.9),
            _with_kwargs(draw_top_nms_proposals, min_score=0.75),
            _with_kwargs(draw_top_nms_proposals, min_score=0.05),
            _with_kwargs(draw_batch_proposals, display="anchor"),
            _with_kwargs(draw_batch_proposals, display="proposal"),
            _with_kwargs(draw_batch_proposals, display="proposal",
                         draw_all=False),
            _with_kwargs(draw_batch_proposals, display="proposal",
                         top_k=10, draw_all=False),
            _with_kwargs(draw_batch_proposals, display="proposal",
                         top_k=20, draw_all=False),
            _with_kwargs(draw_batch_proposals, display="anchor",
                         top_k=10, draw_all=False),
            _with_kwargs(draw_batch_proposals, display="anchor",
                         top_k=20, draw_all=False),
            _with_kwargs(draw_rpn_cls_loss, foreground=True, topn=10,
                         worst=True),
            _with_kwargs(draw_rpn_cls_loss, foreground=True, topn=10,
                         worst=False),
            _with_kwargs(draw_rpn_cls_loss, foreground=False, topn=10,
                         worst=True),
            _with_kwargs(draw_rpn_cls_loss, foreground=False, topn=10,
                         worst=False),
            _with_kwargs(draw_rpn_cls_loss, foreground=True, topn=20,
                         worst=True),
            _with_kwargs(draw_rpn_cls_loss, foreground=True, topn=20,
                         worst=False),
            _with_kwargs(draw_rpn_cls_loss, foreground=False, topn=20,
                         worst=True),
            _with_kwargs(draw_rpn_cls_loss, foreground=False, topn=20,
                         worst=False),
            draw_rpn_targets,
            draw_rpn_bbox_targets,
            _with_kwargs(draw_rpn_bbox_pred, top_k=1),
            _with_kwargs(draw_rpn_bbox_pred, top_k=5),
            _with_kwargs(draw_rpn_bbox_pred, top_k=10),
            _with_kwargs(draw_rpn_bbox_pred, top_k=20),
            _with_kwargs(draw_rpn_bbox_pred, top_k=40),
            _with_kwargs(draw_rpn_bbox_pred, top_k=80),
            _with_kwargs(draw_rpn_bbox_pred_with_target, worst=True),
            _with_kwargs(draw_rpn_bbox_pred_with_target, worst=False),
            _with_kwargs(draw_rpn_pred_combined_loss, top_k=1),
            _with_kwargs(draw_rpn_pred_combined_loss, top_k=5),
            _with_kwargs(draw_rpn_pred_combined_loss, top_k=10),
            _with_kwargs(draw_rpn_pred_combined_loss, top_k=20),
            _with_kwargs(draw_rpn_pred_combined_loss, top_k=50),
            draw_correct_rpn_proposals_anchors,
            draw_rpn_correct_proposals,
            draw_rcnn_cls_batch,
            draw_rcnn_input_proposals,
            _with_kwargs(draw_rcnn_cls_batch_errors, worst=True),
            _with_kwargs(draw_rcnn_cls_batch_errors, worst=False),
            draw_rcnn_reg_batch_errors,
            draw_object_predictions,
        ],
    },
    "ssd": {
        "train": [draw_gt_boxes, draw_ssd_anchor_matches],
        "eval": [draw_gt_boxes, draw_object_predictions],
        "debug": [
            draw_gt_boxes,
            draw_ssd_anchor_matches,
            draw_ssd_target_proposals,
            _with_kwargs(draw_ssd_cls_loss, foreground=True, worst=True),
            _with_kwargs(draw_ssd_cls_loss, foreground=True, worst=False),
            _with_kwargs(draw_ssd_cls_loss, foreground=False, worst=True),
            _with_kwargs(draw_ssd_cls_loss, foreground=False, worst=False),
            _with_kwargs(draw_ssd_bbox_pred, top_k=1),
            _with_kwargs(draw_ssd_bbox_pred, top_k=5),
            _with_kwargs(draw_ssd_bbox_pred, top_k=10),
            draw_ssd_final_pred_anchors,
            draw_ssd_top_k_anchors_per_gt,
            draw_object_predictions,
        ],
    },
}


def image_vis_summaries(prediction_dict, config=None, image_vis_mode="train",
                        image=None, gt_boxes=None, extra_tag=None,
                        all_anchors=None, variances=None):
    """Run the registered draw functions for the model/mode.

    ``variances`` are the model's encode/decode variances
    (``rcnn.target_normalization_variances`` / ssd ``model.variances``);
    draw functions fall back to the config defaults when omitted.
    Returns {summary_name: uint8 image array}.
    """
    model_type = (config or {}).get("type", "fasterrcnn") if isinstance(
        config, dict
    ) else getattr(config, "type", "fasterrcnn")
    fns = summaries_fn.get(model_type, {}).get(image_vis_mode) or []

    summaries = {}
    for fn in fns:
        name = fn.__name__
        if extra_tag:
            name = f"{name}/{extra_tag}"
        try:
            summaries[name] = fn(
                image,
                prediction_dict=prediction_dict,
                gt_boxes=gt_boxes,
                all_anchors=all_anchors,
                variances=variances,
            )
        except Exception:  # vis must never break training
            continue
    return summaries
