"""ImageNet (ILSVRC DET) reader.

A copy of the JAX package's ``tools/dataset/readers/object_detection/imagenet.py``.

reference: luminoth/tools/dataset/readers/object_detection/imagenet.py.
Directory contract (ILSVRC layout): ``data_dir/ImageSets/DET/{split}.txt``,
``data_dir/Annotations/DET/{split}/.../*.xml``,
``data_dir/Data/DET/{split}/.../*.JPEG``. Labels are WordNet ids; the
optional wnid → words mapping file (``data_dir/devkit/data/map_det.txt``)
drives :meth:`pretty_name`.
"""

import logging
import os

from luminoth_tpu_torch.tools.dataset.readers import (
    InvalidDataDirectory,
    ObjectDetectionReader,
)
from luminoth_tpu_torch.utils.dataset import read_image_bytes, read_xml

logger = logging.getLogger(__name__)


class ImageNetReader(ObjectDetectionReader):
    def __init__(self, data_dir, split, **kwargs):
        super().__init__(**kwargs)
        self._data_dir = data_dir
        self._split = split

        split_file = os.path.join(
            data_dir, "ImageSets", "DET", f"{split}.txt"
        )
        if not os.path.exists(split_file):
            raise InvalidDataDirectory(
                f"Split file not found: {split_file}"
            )
        with open(split_file) as f:
            self._image_ids = [
                line.strip().split()[0] for line in f if line.strip()
            ]

        self._annotations_dir = os.path.join(
            data_dir, "Annotations", "DET", split
        )
        self._images_dir = os.path.join(data_dir, "Data", "DET", split)

        self._wnid_to_words = {}
        map_file = os.path.join(data_dir, "devkit", "data", "map_det.txt")
        if os.path.exists(map_file):
            with open(map_file) as f:
                for line in f:
                    parts = line.strip().split()
                    if len(parts) >= 3:
                        self._wnid_to_words[parts[0]] = " ".join(parts[2:])

    def get_total(self):
        return len(self._image_ids)

    def get_classes(self):
        classes = set()
        for image_id in self._image_ids:
            annotation = self._annotation_for(image_id)
            if annotation is None:
                continue
            for obj in annotation.get("object", []):
                classes.add(obj["name"])
        return sorted(classes)

    def pretty_name(self, label):
        return self._wnid_to_words.get(label, label)

    def _annotation_for(self, image_id):
        path = os.path.join(self._annotations_dir, f"{image_id}.xml")
        if not os.path.exists(path):
            return None
        return read_xml(path)

    def iterate(self):
        for image_id in self._image_ids:
            if self._stop_iteration():
                return
            if self._should_skip(image_id):
                continue
            annotation = self._annotation_for(image_id)
            if annotation is None:
                self.errors += 1
                continue

            gt_boxes = []
            for obj in annotation.get("object", []):
                label = obj["name"]
                if label not in self.classes:
                    continue
                box = obj["bndbox"]
                gt_boxes.append(
                    {
                        "label": self.classes.index(label),
                        "xmin": int(float(box["xmin"])),
                        "ymin": int(float(box["ymin"])),
                        "xmax": int(float(box["xmax"])),
                        "ymax": int(float(box["ymax"])),
                    }
                )
            if not gt_boxes:
                continue

            image_path = os.path.join(self._images_dir, f"{image_id}.JPEG")
            if not os.path.exists(image_path):
                self.errors += 1
                continue

            size = annotation.get("size", {})
            record = {
                "width": int(float(size.get("width", 0))),
                "height": int(float(size.get("height", 0))),
                "depth": 3,
                "filename": f"{image_id}.JPEG",
                "image_raw": read_image_bytes(image_path),
                "gt_boxes": gt_boxes,
            }
            self._will_add_record(record)
            self.yielded_records += 1
            yield record
