"""Prediction command of the port: images and videos → JSON objects and
drawn media.

Counterpart of the JAX package's ``predict.py``, with the same JSON-lines
output (``{"file": ..., "objects": [...]}`` per file) on one CUDA device
(or ``--device cpu``). The weights are the newest training checkpoint
under the config's ``train.job_dir``.

    python -m luminoth_tpu_torch predict images/ -c config.yml

The checkpoint zoo is not ported yet: ``--checkpoint``, and the default
``accurate`` checkpoint taken without ``--config``, raise
``NotImplementedError``. Video IO uses cv2.
"""

import json
import logging
import os
import sys
import time

import click
import numpy as np

from luminoth_tpu_torch.io import read_image
from luminoth_tpu_torch.utils.config import (
    get_config,
    override_config_params,
    proposals_config,
)
from luminoth_tpu_torch.utils.predicting import (
    ZOO_NOT_PORTED,
    PredictorNetwork,
)
from luminoth_tpu_torch.utils.serving import apply_serving_profile
from luminoth_tpu_torch.vis import vis_objects

logger = logging.getLogger(__name__)

IMAGE_FORMATS = ["jpg", "jpeg", "png"]
VIDEO_FORMATS = ["mov", "mp4", "avi"]


def get_file_type(filename):
    extension = filename.split(".")[-1].lower()
    if extension in IMAGE_FORMATS:
        return "image"
    if extension in VIDEO_FORMATS:
        return "video"
    return None


def resolve_files(path_or_dir):
    """Expand paths and directories into a list of predictable files."""
    if not isinstance(path_or_dir, (list, tuple)):
        path_or_dir = [path_or_dir]

    paths = []
    for entry in path_or_dir:
        if os.path.isdir(entry):
            for name in sorted(os.listdir(entry)):
                if get_file_type(name):
                    paths.append(os.path.join(entry, name))
        elif get_file_type(entry):
            paths.append(entry)
    return paths


def filter_classes(objects, only_classes=None, ignore_classes=None):
    if ignore_classes:
        objects = [o for o in objects if o["label"] not in ignore_classes]
    if only_classes:
        objects = [o for o in objects if o["label"] in only_classes]
    return objects


def predict_image(network, path, only_classes=None, ignore_classes=None,
                  save_path=None):
    image = read_image(path)
    objects = network.predict_image(image)
    objects = filter_classes(objects, only_classes, ignore_classes)
    if save_path:
        vis_objects(image, objects).save(save_path)
    return objects


def predict_image_batch(network, paths, only_classes=None,
                        ignore_classes=None, save_paths=None,
                        batch_size=4):
    """Detect over many image files with batched device forwards.

    Yields ``(path, objects)`` in input order; unreadable files yield
    ``(path, None)``. Every group is padded to ``batch_size`` (``pad_to``),
    so the final ragged group keeps the batch shape.
    """
    save_paths = save_paths or {}
    for start in range(0, len(paths), batch_size):
        group = paths[start:start + batch_size]
        images = {}
        for path in group:
            try:
                images[path] = read_image(path)
            except Exception as e:
                logger.exception("Error reading %s: %s", path, e)
        kept = [p for p in group if p in images]
        try:
            results = (
                network.predict_batch(
                    [images[p] for p in kept], pad_to=batch_size
                )
                if kept else []
            )
        except Exception as e:
            # Per-group tolerance, matching the sequential path's
            # per-file handling: log and keep going.
            logger.exception("Error predicting batch %s: %s", kept, e)
            results = []
        by_path = dict(zip(kept, results))
        for path in group:
            objects = by_path.get(path)
            if objects is None:
                yield path, None
                continue
            try:
                objects = filter_classes(
                    objects, only_classes, ignore_classes
                )
                if save_paths.get(path):
                    vis_objects(images[path], objects).save(
                        save_paths[path]
                    )
            except Exception as e:  # per-file tolerance, like sequential
                logger.exception("Error processing %s: %s", path, e)
                yield path, None
                continue
            yield path, objects


def predict_video(network, path, only_classes=None, ignore_classes=None,
                  save_path=None, batch_size=4):
    """Detect objects per frame, batching frames for device throughput."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 25
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    writer = None
    if save_path:
        fourcc = cv2.VideoWriter_fourcc(*"mp4v")
        writer = cv2.VideoWriter(save_path, fourcc, fps, (width, height))

    objects_per_frame = []
    frame_idx = 0
    start = time.time()

    def flush(frames):
        nonlocal frame_idx
        results = network.predict_batch(frames, pad_to=batch_size)
        for rgb, objects in zip(frames, results):
            objects = filter_classes(objects, only_classes, ignore_classes)
            objects_per_frame.append(
                {"frame": frame_idx, "objects": objects}
            )
            if writer is not None:
                drawn = np.asarray(vis_objects(rgb, objects))
                writer.write(drawn[..., ::-1].copy())
            frame_idx += 1

    pending = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        pending.append(frame[..., ::-1])
        if len(pending) == batch_size:
            flush(pending)
            pending = []
    if pending:
        flush(pending)
    elapsed = time.time() - start
    if frame_idx:
        logger.info("Total processing time: %.2fs (%.2f fps)",
                    elapsed, frame_idx / elapsed)
    cap.release()
    if writer is not None:
        writer.release()
    return objects_per_frame


@click.command(help="Obtain a model's predictions.")
@click.argument("path-or-dir", nargs=-1)
@click.option(
    "config_files", "--config", "-c", multiple=True,
    help="Config to use.")
@click.option("--checkpoint", help="Checkpoint to use (not ported).")
@click.option(
    "override_params", "--override", "-o", multiple=True,
    help="Override model config params.")
@click.option(
    "output_path", "--output", "-f", default="-",
    help="Output file with the predictions (JSON lines).")
@click.option(
    "--save-media-to", "-d", help="Directory to store media to.")
@click.option(
    "--min-prob", default=0.5, type=float,
    help="Only get bounding boxes with probability larger than.")
@click.option(
    "--max-detections", default=100, type=int,
    help="Maximum number of detections per image.")
@click.option(
    "--only-class", "-k", default=None, multiple=True,
    help="Class to include when predicting.")
@click.option(
    "--ignore-class", "-K", default=None, multiple=True,
    help="Class to ignore when predicting.")
@click.option(
    "--batch-size", default=1, type=int,
    help="Images per device forward (directories/multi-file runs).")
@click.option(
    "--profile", default="accurate",
    type=click.Choice(["accurate", "fast"]),
    help="Serving profile: 'fast' = uint8 transfer, the 6000/1000 "
         "proposal budget and int8 with calibrated scales (see "
         "utils/serving.py:apply_serving_profile).")
@click.option(
    "--device", default=None,
    help="Torch device (default: the current CUDA device).")
@click.option("--debug", is_flag=True, help="Set debug level logging.")
def predict(path_or_dir, config_files, checkpoint, override_params,
            output_path, save_media_to, min_prob, max_detections,
            only_class, ignore_class, batch_size, profile, device, debug):
    """The port's ``lumi predict``."""
    logging.basicConfig(level=logging.DEBUG if debug else logging.INFO)

    if only_class and ignore_class:
        click.echo(
            "Only one of `only-class` or `ignore-class` may be specified."
        )
        return

    files = resolve_files(list(path_or_dir))
    if not files:
        click.echo("No files to predict found. Accepted formats: {}".format(
            ", ".join(IMAGE_FORMATS + VIDEO_FORMATS)))
        return

    if checkpoint or not config_files:
        raise NotImplementedError(ZOO_NOT_PORTED)
    config = get_config(list(config_files))
    if override_params:
        config = override_config_params(config, override_params)
    config = apply_serving_profile(config, profile)

    # Filter bounding boxes according to the CLI flags.
    proposals = proposals_config(config)
    proposals.total_max_detections = max_detections
    proposals.min_prob_threshold = min_prob

    network = PredictorNetwork(config, device=device)

    if output_path == "-":
        output = sys.stdout
    else:
        output = open(output_path, "w")

    if save_media_to:
        os.makedirs(save_media_to, exist_ok=True)

    def media_path(path):
        if not save_media_to:
            return None
        return os.path.join(save_media_to, "pred_" + os.path.basename(path))

    try:
        # Batched image path: group image files into device-sized forwards.
        image_files = [p for p in files if get_file_type(p) == "image"]
        if batch_size > 1 and len(image_files) > 1:
            save_paths = {p: media_path(p) for p in image_files}
            for path, objects in predict_image_batch(
                network, image_files, only_class, ignore_class,
                save_paths=save_paths, batch_size=batch_size,
            ):
                if objects is None:
                    continue
                output.write(
                    json.dumps({"file": path, "objects": objects}) + "\n"
                )
            files = [p for p in files if get_file_type(p) != "image"]

        for path in files:
            save_path = media_path(path)
            file_type = get_file_type(path)
            try:
                if file_type == "image":
                    objects = predict_image(
                        network, path, only_class, ignore_class, save_path
                    )
                else:
                    if save_path:
                        save_path = os.path.splitext(save_path)[0] + ".mp4"
                    objects = predict_video(
                        network, path, only_class, ignore_class, save_path,
                        batch_size=batch_size if batch_size > 1 else 4,
                    )
            except Exception as e:  # keep going over remaining files
                logger.exception("Error processing %s: %s", path, e)
                continue
            output.write(
                json.dumps({"file": path, "objects": objects}) + "\n"
            )
    finally:
        if output is not sys.stdout:
            output.close()
