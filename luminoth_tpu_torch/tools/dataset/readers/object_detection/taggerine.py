"""Taggerine reader: JSON annotation files from the Taggerine tool.

A copy of the JAX package's ``tools/dataset/readers/object_detection/taggerine.py``.

reference: luminoth/tools/dataset/readers/object_detection/taggerine.py.
``data_dir/{split}/`` holds images plus one or more ``.json`` files mapping
image filename → list of label dicts, each either
``{x, y, width, height, label}`` or ``{x_min, y_min, x_max, y_max, label}``
(coordinates may be normalized to [0, 1]).
"""

import json
import logging
import os

from luminoth_tpu_torch.tools.dataset.readers import (
    InvalidDataDirectory,
    ObjectDetectionReader,
)
from luminoth_tpu_torch.utils.dataset import image_size, read_image_bytes

logger = logging.getLogger(__name__)

VALID_KEYSETS = [
    ("x", "y", "width", "height"),
    ("x_min", "y_min", "x_max", "y_max"),
]


class TaggerineReader(ObjectDetectionReader):
    def __init__(self, data_dir, split, default_class=0, **kwargs):
        super().__init__(**kwargs)
        self._data_dir = data_dir
        self._split = split
        self._default_class = default_class
        self._split_path = os.path.join(data_dir, split)

        if not os.path.isdir(self._split_path):
            raise InvalidDataDirectory(
                f'Directory for split "{split}" does not exist'
            )

        json_files = [
            f for f in os.listdir(self._split_path)
            if f.lower().endswith(".json")
        ]
        if not json_files:
            raise InvalidDataDirectory(
                f"Could not find annotations in {self._split_path}; "
                "expected a .json file with Taggerine annotations."
            )

        self.annotations = []
        for filename in json_files:
            path = os.path.join(self._split_path, filename)
            with open(path) as f:
                try:
                    data = json.load(f)
                except json.JSONDecodeError:
                    continue
            if not isinstance(data, dict):
                continue
            for image_filename, labels in data.items():
                if not isinstance(labels, list):
                    continue
                if not all(self._valid_label(lbl) for lbl in labels):
                    continue
                self.annotations.append(
                    {
                        "image_id": os.path.basename(image_filename),
                        "filename": image_filename,
                        "path": os.path.join(
                            self._split_path, image_filename
                        ),
                        "gt_boxes": labels,
                    }
                )

    @staticmethod
    def _valid_label(label):
        return any(
            all(key in label for key in keyset) for keyset in VALID_KEYSETS
        )

    def get_total(self):
        return len(self.annotations)

    def get_classes(self):
        # key=str: labels may mix ints (default_class fallback) and
        # strings; a plain sort would raise TypeError.
        return sorted(
            {
                b.get("label", self._default_class)
                for r in self.annotations
                for b in r["gt_boxes"]
            },
            key=str,
        )

    @staticmethod
    def _to_corners(label, width, height):
        if all(k in label for k in ("x_min", "y_min", "x_max", "y_max")):
            x1, y1, x2, y2 = (
                label["x_min"], label["y_min"], label["x_max"], label["y_max"]
            )
        else:
            x1 = label["x"]
            y1 = label["y"]
            x2 = x1 + label["width"]
            y2 = y1 + label["height"]
        # Normalized coordinates → pixels.
        if max(abs(float(x2)), abs(float(y2))) <= 1.0:
            x1, x2 = x1 * width, x2 * width
            y1, y2 = y1 * height, y2 * height
        return int(x1), int(y1), int(x2), int(y2)

    def iterate(self):
        for record_info in self.annotations:
            if self._stop_iteration():
                return
            if self._should_skip(record_info["image_id"]):
                continue
            path = record_info["path"]
            if not os.path.exists(path):
                self.errors += 1
                continue

            image_raw = read_image_bytes(path)
            width, height, depth = image_size(image_raw)

            gt_boxes = []
            for label in record_info["gt_boxes"]:
                cls = label.get("label", self._default_class)
                if cls not in self.classes:
                    continue
                x1, y1, x2, y2 = self._to_corners(label, width, height)
                gt_boxes.append(
                    {
                        "label": self.classes.index(cls),
                        "xmin": x1,
                        "ymin": y1,
                        "xmax": x2,
                        "ymax": y2,
                    }
                )
            if not gt_boxes:
                continue

            record = {
                "width": width,
                "height": height,
                "depth": depth,
                "filename": record_info["filename"],
                "image_raw": image_raw,
                "gt_boxes": gt_boxes,
            }
            self._will_add_record(record)
            self.yielded_records += 1
            yield record
