"""TFRecord writer for object-detection datasets.

A copy of the JAX package's ``tools/dataset/writers/object_detection_writer.py``.

reference: luminoth/tools/dataset/writers/object_detection_writer.py:47-177.
Validates the record contract, writes SequenceExample TFRecords (readable
by both this toolkit and the reference) plus ``classes.json``.
"""

import json
import logging
import os

from luminoth_tpu_torch.formats.example_pb import encode_sequence_example
from luminoth_tpu_torch.formats.tfrecord import TFRecordWriter

logger = logging.getLogger(__name__)

REQUIRED_KEYS = {"width", "height", "depth", "filename", "image_raw",
                 "gt_boxes"}
REQUIRED_BOX_KEYS = {"label", "xmin", "ymin", "xmax", "ymax"}


class InvalidRecord(Exception):
    pass


def validate_record(record):
    missing = REQUIRED_KEYS - set(record)
    if missing:
        raise InvalidRecord(f"missing keys: {missing}")
    if not record["gt_boxes"]:
        raise InvalidRecord("record has no gt_boxes")
    for box in record["gt_boxes"]:
        box_missing = REQUIRED_BOX_KEYS - set(box)
        if box_missing:
            raise InvalidRecord(f"gt box missing keys: {box_missing}")


def record_to_bytes(record):
    """Serialize one record dict into SequenceExample bytes."""
    filename = record["filename"]
    if isinstance(filename, str):
        filename = filename.encode("utf-8")
    context = {
        "image_raw": record["image_raw"],
        "filename": filename,
        "width": int(record["width"]),
        "height": int(record["height"]),
        "depth": int(record["depth"]),
    }
    boxes = record["gt_boxes"]
    lists = {
        "label": [[int(b["label"])] for b in boxes],
        "xmin": [[int(b["xmin"])] for b in boxes],
        "ymin": [[int(b["ymin"])] for b in boxes],
        "xmax": [[int(b["xmax"])] for b in boxes],
        "ymax": [[int(b["ymax"])] for b in boxes],
    }
    return encode_sequence_example(context, lists)


class ObjectDetectionWriter:
    """Consume a reader and write ``{split}.tfrecords`` + classes.json."""

    def __init__(self, reader, output_dir, split="train"):
        self._reader = reader
        self._output_dir = output_dir
        self._split = split

    def save(self):
        os.makedirs(self._output_dir, exist_ok=True)
        record_path = os.path.join(
            self._output_dir, f"{self._split}.tfrecords"
        )

        written = 0
        skipped = 0
        with TFRecordWriter(record_path) as writer:
            for record in self._reader.iterate():
                try:
                    validate_record(record)
                except InvalidRecord as e:
                    logger.debug("skipping invalid record: %s", e)
                    skipped += 1
                    continue
                writer.write(record_to_bytes(record))
                written += 1

        classes = self._reader.classes
        if classes:
            classes_path = os.path.join(self._output_dir, "classes.json")
            with open(classes_path, "w") as f:
                json.dump([str(c) for c in classes], f)

        logger.info(
            "Saved %d records (%d skipped) to %s",
            written, skipped, record_path,
        )
        return written
