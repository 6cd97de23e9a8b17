"""COCO reader (annotation JSON).

A copy of the JAX package's ``tools/dataset/readers/object_detection/coco.py``.

reference: luminoth/tools/dataset/readers/object_detection/coco.py.
Directory contract: ``data_dir/annotations/instances_{split}.json``
(or ``instances_{split}{year}.json``) with images under
``data_dir/{split}/`` or ``data_dir/images/{split}/``.
"""

import json
import logging
import os

from luminoth_tpu_torch.tools.dataset.readers import (
    InvalidDataDirectory,
    ObjectDetectionReader,
)
from luminoth_tpu_torch.utils.dataset import read_image_bytes

logger = logging.getLogger(__name__)


class COCOReader(ObjectDetectionReader):
    def __init__(self, data_dir, split, year=None, use_supercategory=False,
                 **kwargs):
        super().__init__(**kwargs)
        self._data_dir = data_dir
        self._split = split
        self._use_supercategory = use_supercategory

        annotations_dir = os.path.join(data_dir, "annotations")
        candidates = [f"instances_{split}.json"]
        if year:
            candidates.insert(0, f"instances_{split}{year}.json")
        else:
            # Common COCO year-suffixed layouts.
            candidates += [
                f"instances_{split}2017.json",
                f"instances_{split}2014.json",
            ]
        annotation_path = None
        for name in candidates:
            path = os.path.join(annotations_dir, name)
            if os.path.exists(path):
                annotation_path = path
                break
        if annotation_path is None:
            raise InvalidDataDirectory(
                f"Could not find annotation file for split {split} "
                f"in {annotations_dir}"
            )

        with open(annotation_path) as f:
            data = json.load(f)

        self._categories = sorted(
            data["categories"], key=lambda c: c["id"]
        )
        self._category_by_id = {c["id"]: c for c in self._categories}
        self._images = data["images"]
        self._image_by_id = {im["id"]: im for im in self._images}

        self._annotations_by_image = {}
        for ann in data.get("annotations", []):
            if ann.get("iscrowd"):
                continue
            self._annotations_by_image.setdefault(
                ann["image_id"], []
            ).append(ann)

        # Candidate image directories, tried in order at read time.
        self._image_dirs = [
            os.path.join(data_dir, split),
            os.path.join(data_dir, "images", split),
            os.path.join(data_dir, f"{split}2017"),
            os.path.join(data_dir, f"{split}2014"),
            data_dir,
        ]

    def get_total(self):
        return len(self._images)

    def get_classes(self):
        key = "supercategory" if self._use_supercategory else "name"
        return sorted({c[key] for c in self._categories})

    def _class_for_category(self, category_id):
        cat = self._category_by_id[category_id]
        key = "supercategory" if self._use_supercategory else "name"
        name = cat[key]
        if name not in self.classes:
            return None
        return self.classes.index(name)

    def _find_image(self, file_name):
        for directory in self._image_dirs:
            path = os.path.join(directory, file_name)
            if os.path.exists(path):
                return path
        return None

    def iterate(self):
        for image_info in self._images:
            if self._stop_iteration():
                return
            image_id = image_info["id"]
            if self._should_skip(str(image_id)) and self._should_skip(
                image_info.get("file_name")
            ):
                continue

            annotations = self._annotations_by_image.get(image_id, [])
            gt_boxes = []
            for ann in annotations:
                label = self._class_for_category(ann["category_id"])
                if label is None:
                    continue
                x, y, w, h = ann["bbox"]
                gt_boxes.append(
                    {
                        "label": label,
                        "xmin": int(x),
                        "ymin": int(y),
                        "xmax": int(x + w),
                        "ymax": int(y + h),
                    }
                )
            if not gt_boxes:
                continue

            path = self._find_image(image_info["file_name"])
            if path is None:
                self.errors += 1
                continue

            record = {
                "width": image_info["width"],
                "height": image_info["height"],
                "depth": 3,
                "filename": image_info["file_name"],
                "image_raw": read_image_bytes(path),
                "gt_boxes": gt_boxes,
            }
            self._will_add_record(record)
            self.yielded_records += 1
            yield record
