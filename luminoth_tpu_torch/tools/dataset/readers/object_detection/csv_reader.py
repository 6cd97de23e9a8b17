"""CSV reader: one row per ground-truth box.

A copy of the JAX package's ``tools/dataset/readers/object_detection/csv_reader.py``.

reference: luminoth/tools/dataset/readers/object_detection/csv_reader.py.
``data_dir/{split}.csv`` with columns (configurable when headerless):
image_id, xmin, ymin, xmax, ymax, label. Images under ``data_dir/{split}/``
or ``data_dir/images/``.
"""

import csv
import logging
import os

from luminoth_tpu_torch.tools.dataset.readers import (
    InvalidDataDirectory,
    ObjectDetectionReader,
)
from luminoth_tpu_torch.utils.dataset import image_size, read_image_bytes

logger = logging.getLogger(__name__)


class CSVReader(ObjectDetectionReader):
    DEFAULT_COLUMNS = ["image_id", "xmin", "ymin", "xmax", "ymax", "label"]

    def __init__(self, data_dir, split, headers=True, columns=None, **kwargs):
        super().__init__(**kwargs)
        self._data_dir = data_dir
        self._split = split
        if columns is not None:
            if isinstance(columns, str):
                columns = columns.split(",")
        else:
            columns = self.DEFAULT_COLUMNS
        self._columns = columns
        self._has_headers = headers

        self._csv_path = os.path.join(data_dir, f"{split}.csv")
        if not os.path.exists(self._csv_path):
            raise InvalidDataDirectory(
                f"CSV file not found: {self._csv_path}"
            )

        self._annotations_by_image = {}
        with open(self._csv_path, newline="") as f:
            if self._has_headers:
                reader = csv.DictReader(f)
            else:
                reader = csv.DictReader(f, fieldnames=self._columns)
            for row in reader:
                image_id = row["image_id"]
                self._annotations_by_image.setdefault(image_id, []).append(row)

    def get_total(self):
        return len(self._annotations_by_image)

    def get_classes(self):
        return sorted(
            {
                row["label"]
                for rows in self._annotations_by_image.values()
                for row in rows
            }
        )

    def _find_image(self, image_id):
        candidates = [
            os.path.join(self._data_dir, self._split, image_id),
            os.path.join(self._data_dir, "images", image_id),
            os.path.join(self._data_dir, image_id),
        ]
        for base in list(candidates):
            for ext in ("", ".jpg", ".jpeg", ".png"):
                path = base + ext
                if os.path.exists(path):
                    return path
        return None

    def iterate(self):
        for image_id, rows in self._annotations_by_image.items():
            if self._stop_iteration():
                return
            if self._should_skip(image_id):
                continue

            gt_boxes = []
            for row in rows:
                label = row["label"]
                if label not in self.classes:
                    continue
                gt_boxes.append(
                    {
                        "label": self.classes.index(label),
                        "xmin": int(float(row["xmin"])),
                        "ymin": int(float(row["ymin"])),
                        "xmax": int(float(row["xmax"])),
                        "ymax": int(float(row["ymax"])),
                    }
                )
            if not gt_boxes:
                continue

            path = self._find_image(image_id)
            if path is None:
                self.errors += 1
                continue

            image_raw = read_image_bytes(path)
            width, height, depth = image_size(image_raw)
            record = {
                "width": width,
                "height": height,
                "depth": depth,
                "filename": os.path.basename(path),
                "image_raw": image_raw,
                "gt_boxes": gt_boxes,
            }
            self._will_add_record(record)
            self.yielded_records += 1
            yield record
