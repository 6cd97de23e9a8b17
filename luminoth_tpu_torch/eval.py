"""Streaming evaluator of the port: checkpoint watcher and COCO-style
mAP/mAR.

Counterpart of the JAX package's ``eval.py`` on one CUDA device (or the CPU,
for tests), with the same names and semantics. The forward runs the model
in eval mode with the ground truth, so the RPN and RCNN targets are
assigned (on all the proposals) and the eval losses come with the
detections; the metrics are computed on the host in numpy.

    python -m luminoth_tpu_torch eval -c config.yml [--no-watch]

Checkpoints are the port's ``ckpt_step_<N>.pt`` and the JAX package's
``ckpt_step_<N>.msgpack`` under ``<job_dir>/<run_name>/ckpt``. The model
carries its weights, so :func:`evaluate_once` takes no ``variables``.

With a summary writer, ``files_per_class`` > 0 writes up to that many
``draw_object_predictions`` images per detected class (tags
``<class>/<n>``, probability at least 0.5), as the JAX package does.

Data-parallel evaluation (the JAX package's ``_eval_mesh``): in one
process, the model is replicated on each of the largest number of devices
that divides the batch (``evaluate_once(devices=...)``; ``eval`` takes
every visible CUDA device). Each replica runs its rows of the batch, all
forwards are launched before any output is read, and the predictions are
gathered in batch order on the first device, where the losses are taken
over the whole batch, as on one device.
"""

import logging
import os
import time

import click
import numpy as np
import torch

from luminoth_tpu_torch.datasets import get_dataset
from luminoth_tpu_torch.models import get_model
from luminoth_tpu_torch.ops.np_boxes import bbox_overlap
from luminoth_tpu_torch.parallel.mesh import (
    data_parallel_count,
    replicate,
    run_replicas,
)
from luminoth_tpu_torch.formats.tfevents import SummaryWriter
from luminoth_tpu_torch.train import prefetch_to_device
from luminoth_tpu_torch.utils.checkpoint_io import (
    CheckpointManager,
    load_model_weights,
)
from luminoth_tpu_torch.utils.config import get_config, proposals_config
from luminoth_tpu_torch.utils.image_vis import draw_object_predictions
from luminoth_tpu_torch.utils.predicting import model_dtype, resolve_device

logger = logging.getLogger(__name__)


def calculate_metrics(output_per_batch, num_classes):
    """Per-class AP/AR over IoU 0.50:0.95, 101-point interpolation.

    Greedy score-ordered matching: each detection matches its highest-IoU
    ground truth; a gt can be matched once per IoU threshold; duplicates are
    false positives.

    Returns:
        ``(ap_per_class, ar_per_class)`` arrays of shape
        (num_classes, num_iou_thresholds).
    """
    iou_thresholds = np.linspace(0.50, 0.95, 10)
    rec_thresholds = np.linspace(0.0, 1.0, 101)

    tp_fp_by_class = [[] for _ in range(num_classes)]
    num_gt_per_class = [0] * num_classes

    num_batches = len(output_per_batch["bboxes"])
    for idx in range(num_batches):
        classes = np.asarray(output_per_batch["classes"][idx])
        bboxes = np.asarray(output_per_batch["bboxes"][idx])
        scores = np.asarray(output_per_batch["scores"][idx])
        gt_classes = np.asarray(output_per_batch["gt_classes"][idx])
        gt_bboxes = np.asarray(output_per_batch["gt_bboxes"][idx])

        for cls in range(num_classes):
            cls_bboxes = bboxes[classes == cls, :]
            cls_scores = scores[classes == cls]
            cls_gt_bboxes = gt_bboxes[gt_classes == cls, :]

            num_gt = cls_gt_bboxes.shape[0]
            num_gt_per_class[cls] += num_gt

            sorted_indices = np.argsort(-cls_scores)
            is_detected = np.zeros((num_gt, len(iou_thresholds)), bool)
            tp_fp = np.zeros((len(cls_scores), len(iou_thresholds)))

            if num_gt == 0:
                tp_fp_by_class[cls].append((tp_fp, cls_scores[sorted_indices]))
                continue

            ious = bbox_overlap(cls_bboxes, cls_gt_bboxes)
            for rank, bbox_idx in enumerate(sorted_indices):
                gt_match = int(np.argmax(ious[bbox_idx, :]))
                match_iou = ious[bbox_idx, gt_match]
                for iou_idx, thresh in enumerate(iou_thresholds):
                    if match_iou >= thresh and not is_detected[
                        gt_match, iou_idx
                    ]:
                        tp_fp[rank, iou_idx] = True
                        is_detected[gt_match, iou_idx] = True

            tp_fp_by_class[cls].append((tp_fp, cls_scores[sorted_indices]))

    ap_per_class = np.zeros((num_classes, len(iou_thresholds)))
    ar_per_class = np.zeros((num_classes, len(iou_thresholds)))
    for cls in range(num_classes):
        if not tp_fp_by_class[cls]:  # zero evaluated batches
            continue
        labels, scores = zip(*tp_fp_by_class[cls])
        labels = np.concatenate(labels)
        scores = np.concatenate(scores)
        num_examples = num_gt_per_class[cls]
        if num_examples == 0:
            continue

        order = np.argsort(-scores)
        true_positives = labels[order, :]
        false_positives = 1 - true_positives
        cum_tp = np.cumsum(true_positives, axis=0)
        cum_fp = np.cumsum(false_positives, axis=0)

        recall = cum_tp.astype(float) / num_examples
        with np.errstate(divide="ignore", invalid="ignore"):
            precision = np.where(
                (cum_tp + cum_fp) > 0, cum_tp / (cum_tp + cum_fp), 0.0
            )

        for iou_idx in range(len(iou_thresholds)):
            p = precision[:, iou_idx].copy()
            r = recall[:, iou_idx]
            # Monotone interpolation of the precision envelope.
            for i in range(len(p) - 1, 0, -1):
                if p[i] > p[i - 1]:
                    p[i - 1] = p[i]

            ap = 0.0
            inds = np.searchsorted(r, rec_thresholds)
            for pidx in inds:
                if pidx >= len(r):
                    break
                ap += p[pidx] / len(rec_thresholds)
            ap_per_class[cls, iou_idx] = ap
            ar_per_class[cls, iou_idx] = r[-1] if len(r) else 0.0

    return ap_per_class, ar_per_class


def _checkpoint_files(run_dir):
    """``[(step, suffix)]`` of the run's checkpoints, oldest first, one
    file per step (the ``.pt`` where a step has both formats)."""
    ckpt_dir = os.path.join(run_dir, "ckpt")
    if not os.path.isdir(ckpt_dir):
        return []
    return CheckpointManager(ckpt_dir).evaluable_steps()


def get_checkpoints(run_dir, last_step=0):
    """New checkpoint steps in the run dir since ``last_step``."""
    return [step for step, _ in _checkpoint_files(run_dir)
            if step > last_step]


def eval_forward(model, image, gt_boxes, im_shape):
    """One eval forward: the detections and the batch's mean losses."""
    if image.dtype == torch.uint8:
        image = image.float()  # dataset.transfer_dtype=uint8
    preds = model(image, gt_boxes=gt_boxes, im_shape=im_shape)
    cp = preds["classification_prediction"]
    losses = model.loss(preds, return_all=True)
    return cp["objects"], cp["labels"], cp["probs"], cp["valid"], losses


def replicated_forward(replicas):
    """The eval forward data-parallel over ``replicas`` (the model first,
    then its copies; :func:`~luminoth_tpu_torch.parallel.mesh.replicate`):
    replica ``i`` runs row block ``i`` of the batch (its fixed target
    draws are that block of the global batch's), every forward is
    launched before any is read, and the predictions are joined in batch
    order on the batch's device, where the model's loss is taken."""
    model = replicas[0]

    def forward(_, image, gt_boxes, im_shape):
        if image.dtype == torch.uint8:
            image = image.float()
        merged = run_replicas(
            replicas, lambda replica, x, gt, shape: replica(
                x, gt_boxes=gt, im_shape=shape), image, gt_boxes, im_shape)
        cp = merged["classification_prediction"]
        losses = model.loss(merged, return_all=True)
        return cp["objects"], cp["labels"], cp["probs"], cp["valid"], losses

    return forward


def eval_devices(batch_size, device=None):
    """The devices ``eval`` runs on: ``device`` when given, else the
    largest number of visible CUDA devices that divides the batch (one:
    the current device)."""
    if device is not None or not torch.cuda.is_available():
        return [resolve_device(device)]
    count = data_parallel_count(batch_size, torch.cuda.device_count())
    if count == 1:
        return [resolve_device(None)]
    return [torch.device("cuda", i) for i in range(count)]


def _fetch(outs):
    """Queue the host copies of a forward's outputs.

    Returns ``(tensors, loss names, ready event)``. On CUDA the copies are
    asynchronous (into pinned memory) and follow the forward on the stream,
    so waiting for ``ready`` does not wait for a forward launched later.
    """
    objects, labels, probs, valid, losses = outs
    names = sorted(losses)
    tensors = [objects, labels, probs, valid,
               torch.stack([losses[name].float() for name in names])]
    if not tensors[0].is_cuda:
        return tensors, names, None
    tensors = [t.to("cpu", non_blocking=True) for t in tensors]
    ready = torch.cuda.Event()
    ready.record()
    return tensors, names, ready


def evaluate_once(config, model, writer=None, global_step=0, forward=None,
                  max_batches=None, files_per_class=0, devices=None):
    """Evaluate ``model`` (with its weights) over the configured split.

    Returns a metrics dict (AP/AR aggregates, mean losses, the image count
    and rate; on CUDA also ``forward_device_ms``, the mean device span of
    one forward). ``forward(model, image, gt_boxes, im_shape)`` returns
    ``(objects, labels, probs, valid, losses)``; by default
    :func:`eval_forward`. The batches go to the model's device.

    ``devices``: evaluate data-parallel over the largest number of them
    that divides the batch (a device may repeat): ``model`` moves to the
    first and a copy of it goes to each other (:func:`replicated_forward`).
    """
    num_classes = int(config.model.network.num_classes)
    dataset = get_dataset(config.dataset.type)(
        config, shuffle=False, num_epochs=1, augment=False,
        pad_final_batch=True,
    )
    if devices is not None and len(devices) > 1:
        count = data_parallel_count(
            int(config.train.get("batch_size") or 1), len(devices))
        if count > 1:
            replicas = replicate(model.eval(), devices[:count])
            logger.info("Evaluating data-parallel over %d devices", count)
            if forward is None:
                forward = replicated_forward(replicas)
    if forward is None:
        forward = eval_forward
    device = torch.device("cpu")
    if model is not None:
        model.eval()
        device = next(model.parameters()).device
    saved_per_class = {}

    def maybe_save_images(batch, b, objects, labels, probs, keep):
        if writer is None or not files_per_class:
            return
        for cls in set(labels[keep].astype(int).tolist()):
            if saved_per_class.get(cls, 0) >= files_per_class:
                continue
            saved_per_class[cls] = saved_per_class.get(cls, 0) + 1
            img = draw_object_predictions(
                batch["image"][b],
                prediction_dict={
                    "objects": objects, "labels": labels, "probs": probs,
                    "valid": keep,
                },
                min_prob=0.5,
            )
            writer.add_image(
                f"{cls}/{saved_per_class[cls]}", img, global_step,
                dataformats="HWC",
            )

    output = {k: [] for k in
              ("bboxes", "classes", "scores", "gt_bboxes", "gt_classes")}
    loss_sums = {}
    count = 0
    start = time.time()
    total_images = 0
    spans = []  # (start, end) CUDA events around each forward

    def bounded():
        for batch_idx, batch in enumerate(dataset):
            if max_batches is not None and batch_idx >= max_batches:
                return
            yield batch

    def drain(pending_batch, fetched):
        nonlocal count, total_images
        tensors, names, ready = fetched
        if ready is not None:
            ready.synchronize()
        objects, labels, probs, valid, losses = (t.numpy() for t in tensors)
        # Final partial batches arrive padded (repeated rows at the
        # tail); skip them so every real image counts exactly once.
        batch_size = objects.shape[0] - int(
            pending_batch.get("pad_count", 0)
        )
        total_images += batch_size
        for b in range(batch_size):
            keep = valid[b].astype(bool)
            output["bboxes"].append(objects[b][keep])
            output["classes"].append(labels[b][keep])
            output["scores"].append(probs[b][keep])
            gt = pending_batch["gt_boxes"][b]
            gt_keep = gt[:, 4] >= 0
            output["gt_bboxes"].append(gt[gt_keep][:, :4])
            output["gt_classes"].append(gt[gt_keep][:, 4].astype(np.int64))
            maybe_save_images(pending_batch, b, objects[b], labels[b],
                              probs[b], keep)
        # Weight each batch's mean loss by its REAL image count so a
        # padded final batch does not count like a full batch.
        for name, value in zip(names, losses):
            loss_sums[name] = (
                loss_sums.get(name, 0.0) + float(value) * batch_size
            )
        count += 1
        if count % 10 == 0:
            rate = total_images / (time.time() - start)
            logger.info("%d images evaluated (%.2f images/s)",
                        total_images, rate)

    # Two overlaps: batch k+1's upload is in flight while k's forward runs
    # (prefetch_to_device), and k+1's forward is launched before k's
    # outputs are read on the host, so the device computes k+1 while the
    # host accumulates k's detections. Nothing in the loop waits for the
    # device before the next forward is launched.
    pending = None
    with torch.inference_mode():
        for batch, device_batch in prefetch_to_device(bounded(), device):
            if device.type == "cuda":
                spans.append(tuple(torch.cuda.Event(enable_timing=True)
                                   for _ in range(2)))
                spans[-1][0].record()
            outs = forward(model, device_batch["image"],
                           device_batch["gt_boxes"],
                           device_batch["im_shape"])
            if spans:
                spans[-1][1].record()
            fetched = _fetch(outs)
            if pending is not None:
                drain(*pending)
            pending = (batch, fetched)
        if pending is not None:
            drain(*pending)

    elapsed = time.time() - start
    logger.info(
        "Evaluated %d images in %.2fs (%.2f images/s)",
        total_images, elapsed, total_images / max(elapsed, 1e-6),
    )

    ap_per_class, ar_per_class = calculate_metrics(output, num_classes)
    metrics = {
        "AP@0.5": float(np.mean(ap_per_class[:, 0])),
        "AP@0.75": float(np.mean(ap_per_class[:, 5])),
        "AP@[0.5:0.95]": float(np.mean(ap_per_class)),
        "AR@[0.5:0.95]": float(np.mean(ar_per_class)),
        "images": total_images,
        "images_per_second": total_images / max(elapsed, 1e-6),
    }
    for name, total in loss_sums.items():
        metrics[f"losses/{name}"] = total / max(total_images, 1)
    if spans:
        torch.cuda.synchronize(device)
        metrics["forward_device_ms"] = float(np.mean(
            [s.elapsed_time(e) for s, e in spans]))

    if writer is not None:
        for name, value in metrics.items():
            writer.add_scalar(f"validation/{name}", value, global_step)
        writer.flush()

    logger.info("Validation metrics at step %d: %s", global_step, {
        k: round(v, 4) for k, v in metrics.items()
    })
    return metrics


def apply_eval_config_mutations(config, dataset_split, max_detections=100):
    """Evaluation-mode config mutations, as in the JAX package.

    Disables augmentation and shuffling and zeroes the score floor. For
    Faster R-CNN it also forces ``pre_nms_max_candidates=0``: eval NMS-es
    ALL the post-RPN proposals per class (the 512-candidate cap of the base
    config is a serving setting), so the mAP measured here has the
    reference's semantics. For SSD the zero floor moves the detections to
    the per-class path.
    """
    config.dataset.split = dataset_split
    config.train.num_epochs = 1
    config.dataset.data_augmentation = None
    config.train.random_shuffle = False
    proposals = proposals_config(config)
    if config.model.type == "fasterrcnn":
        proposals.pre_nms_max_candidates = 0
    proposals.total_max_detections = max_detections
    proposals.min_prob_threshold = 0.0
    return config


def watch_checkpoints(config, model, run_dir, watch=True,
                      from_global_step=None, writer=None, forward=None,
                      files_per_class=0, devices=None):
    """Evaluate each new checkpoint in ``run_dir`` (the eval loop body).

    Each checkpoint's weights are loaded into ``model`` in turn. A
    partially written checkpoint is tolerated: an unreadable newest file
    is retried (it may still be mid-transfer), unreadable older files are
    skipped (they will never heal).
    """
    manager = None
    last_step = from_global_step or 0

    while True:
        files = [(step, suffix) for step, suffix in _checkpoint_files(run_dir)
                 if step > last_step]
        if not files:
            if not watch:
                break
            time.sleep(5)
            continue
        if manager is None:
            manager = CheckpointManager(os.path.join(run_dir, "ckpt"))
        for step, suffix in files:
            try:
                state = manager.read(step, suffix)
            except FileNotFoundError:
                continue  # checkpoint rotated away while watching
            except Exception as e:
                if watch and step == files[-1][0]:
                    logger.warning(
                        "Checkpoint step %d unreadable (%s); retrying",
                        step, e,
                    )
                    time.sleep(5)
                    break
                logger.warning(
                    "Checkpoint step %d unreadable (%s); skipping",
                    step, e,
                )
                last_step = step
                continue
            load_model_weights(model, state)
            logger.info("Evaluating checkpoint at step %d", step)
            evaluate_once(
                config, model, writer=writer, global_step=step,
                forward=forward, files_per_class=files_per_class,
                devices=devices,
            )
            last_step = step
        if not watch:
            break


@click.command(help="Evaluate trained (or training) models")
@click.option(
    "dataset_split", "--split", default="val", help="Dataset split to use.")
@click.option(
    "config_files", "--config", "-c", required=True, multiple=True,
    help="Config to use.")
@click.option(
    "--watch/--no-watch", default=True,
    help="Keep watching checkpoint directory for new files.")
@click.option(
    "--from-global-step", type=int, default=None,
    help="Consider only checkpoints after this step.")
@click.option(
    "override_params", "--override", "-o", multiple=True,
    help="Override model config params.")
@click.option(
    "--files-per-class", type=int, default=10,
    help="How many files per class to save (visualization).")
@click.option(
    "--max-detections", type=int, default=100,
    help="Maximum detections considered per image.")
@click.option(
    "--device", default=None,
    help="Torch device (default: the largest number of visible CUDA "
         "devices that divides the batch).")
def eval(dataset_split, config_files, watch, from_global_step,
         override_params, files_per_class, max_detections, device):
    """The port's ``lumi eval``."""
    logging.basicConfig(level=logging.INFO)
    config = get_config(list(config_files), override_params=override_params)
    apply_eval_config_mutations(config, dataset_split, max_detections)
    devices = eval_devices(int(config.train.get("batch_size") or 1), device)
    model = get_model(config.model.type)(
        config, dtype=model_dtype(config)).to(devices[0])

    run_dir = os.path.join(config.train.get("job_dir", "jobs/"),
                           config.train.get("run_name") or "default")
    writer = SummaryWriter(os.path.join(run_dir, dataset_split))
    watch_checkpoints(
        config, model, run_dir, watch=watch,
        from_global_step=from_global_step, writer=writer,
        files_per_class=files_per_class, devices=devices,
    )
