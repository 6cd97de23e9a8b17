"""Synthetic object-detection records for smoke runs of the training loop.

:func:`write_synthetic_records` writes ``<directory>/<split>.tfrecords``
(uniform-noise JPEGs with random labelled boxes, in the SequenceExample
layout the dataset readers parse) and ``classes.json``. The records are
encoded by the JAX package's TFRecord writer, which is plain Python and
imports no jax (as ``train.py`` reuses its dataset readers).
"""

import io
import json
import os

import numpy as np
from PIL import Image

from luminoth_tpu.formats.example_pb import encode_sequence_example
from luminoth_tpu.formats.tfrecord import TFRecordWriter


def random_boxes(rng, count, height, width, num_classes):
    """(count, 5) integer-valued boxes ``x1 y1 x2 y2 label`` inside the
    image, each side 10-30% of the image's."""
    x1 = rng.uniform(0, width * 0.7, count)
    y1 = rng.uniform(0, height * 0.7, count)
    boxes = np.stack([
        x1, y1, x1 + rng.uniform(width * 0.1, width * 0.3, count),
        y1 + rng.uniform(height * 0.1, height * 0.3, count),
        rng.integers(0, num_classes, count),
    ], -1)
    return boxes.round().astype(np.int64)


def write_synthetic_records(directory, count, num_classes, seed,
                            height=480, width=640, boxes_per_image=(2, 6),
                            split="train"):
    """Write ``count`` records of ``height``x``width`` JPEGs, each with
    ``boxes_per_image`` (inclusive range) boxes, drawn from ``seed``.

    Returns ``(directory, boxes)``: ``boxes[i]`` is image i's (n, 5)
    ``x1 y1 x2 y2 label`` array as written.
    """
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    low, high = boxes_per_image
    written = []
    path = os.path.join(directory, f"{split}.tfrecords")
    with TFRecordWriter(path) as writer:
        for i in range(count):
            image = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
            boxes = random_boxes(rng, int(rng.integers(low, high + 1)),
                                 height, width, num_classes)
            buf = io.BytesIO()
            Image.fromarray(image).save(buf, format="JPEG", quality=90)
            writer.write(encode_sequence_example(
                {"image_raw": buf.getvalue(),
                 "filename": f"img{i}.jpg".encode(),
                 "width": width, "height": height, "depth": 3},
                {name: [[int(v)] for v in boxes[:, col]]
                 for col, name in enumerate(
                     ("xmin", "ymin", "xmax", "ymax", "label"))},
            ))
            written.append(boxes)
    with open(os.path.join(directory, "classes.json"), "w") as f:
        json.dump([f"class{i}" for i in range(num_classes)], f)
    return directory, written
