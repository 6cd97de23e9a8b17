"""Flat reader: one ``.json`` annotation file next to each image.

A copy of the JAX package's ``tools/dataset/readers/object_detection/flat_reader.py``.

reference: luminoth/tools/dataset/readers/object_detection/flat_reader.py.
``data_dir/{split}/`` holds image files and sibling ``{name}.json`` files
with ``{objects_key: [{x1, y1, x2, y2, label?}, ...]}``. Like the
reference (flat_reader.py:178-185), only the json annotation type is
supported — any other ``annotation_type`` raises up front instead of
silently yielding an empty dataset.
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

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png")


class FlatReader(ObjectDetectionReader):
    def __init__(self, data_dir, split, annotation_type="json",
                 default_class=0, objects_key="rects", x_min_key="x1",
                 y_min_key="y1", x_max_key="x2", y_max_key="y2", **kwargs):
        super().__init__(**kwargs)
        if annotation_type != "json":
            raise ValueError(
                "Annotation type {} not supported".format(annotation_type)
            )
        self._data_dir = data_dir
        self._split = split
        self._annotation_type = annotation_type
        self._default_class = default_class
        self._objects_key = objects_key
        self._keys = (x_min_key, y_min_key, x_max_key, y_max_key)

        self._split_path = os.path.join(data_dir, split)
        if not os.path.isdir(self._split_path):
            # Allow flat (splitless) layouts too.
            if os.path.isdir(data_dir):
                self._split_path = data_dir
            else:
                raise InvalidDataDirectory(
                    f"Directory does not exist: {self._split_path}"
                )

        self._errored = set()
        self._annotated = []
        for name in sorted(os.listdir(self._split_path)):
            base, ext = os.path.splitext(name)
            if ext.lower() not in IMAGE_EXTENSIONS:
                continue
            ann_path = os.path.join(
                self._split_path, f"{base}.{self._annotation_type}"
            )
            alt_path = os.path.join(
                self._split_path, f"{name}.{self._annotation_type}"
            )
            if os.path.exists(ann_path):
                self._annotated.append((name, ann_path))
            elif os.path.exists(alt_path):
                self._annotated.append((name, alt_path))

    def get_total(self):
        return len(self._annotated)

    def get_classes(self):
        classes = set()
        for _, ann_path in self._annotated:
            for obj in self._read_objects(ann_path):
                classes.add(obj.get("label", self._default_class))
        # key=str: labels may mix ints (default_class fallback)
        # and strings; a plain sort would raise TypeError.
        return sorted(classes, key=str)

    def _read_objects(self, ann_path):
        try:
            with open(ann_path) as f:
                data = json.load(f)
        except (json.JSONDecodeError, OSError) as exc:
            # Corrupt/unreadable annotation: surface it instead of
            # silently producing an empty dataset. _read_objects runs
            # twice per file (get_classes, then iterate) — count and
            # log each bad file once.
            if ann_path not in self._errored:
                logger.warning("skipping unreadable annotation %s: %s",
                               ann_path, exc)
                self._errored.add(ann_path)
                self.errors += 1
            return []
        if isinstance(data, dict):
            return data.get(self._objects_key, [])
        if isinstance(data, list):
            return data
        return []

    def iterate(self):
        x_min_key, y_min_key, x_max_key, y_max_key = self._keys
        for image_name, ann_path in self._annotated:
            if self._stop_iteration():
                return
            if self._should_skip(image_name):
                continue

            gt_boxes = []
            for obj in self._read_objects(ann_path):
                label = obj.get("label", self._default_class)
                if label not in self.classes:
                    continue
                gt_boxes.append(
                    {
                        "label": self.classes.index(label),
                        "xmin": int(float(obj[x_min_key])),
                        "ymin": int(float(obj[y_min_key])),
                        "xmax": int(float(obj[x_max_key])),
                        "ymax": int(float(obj[y_max_key])),
                    }
                )
            if not gt_boxes:
                continue

            image_path = os.path.join(self._split_path, image_name)
            image_raw = read_image_bytes(image_path)
            width, height, depth = image_size(image_raw)
            record = {
                "width": width,
                "height": height,
                "depth": depth,
                "filename": image_name,
                "image_raw": image_raw,
                "gt_boxes": gt_boxes,
            }
            self._will_add_record(record)
            self.yielded_records += 1
            yield record
