"""Pascal VOC reader (ImageSets/Main split lists + Annotations XML).

A copy of the JAX package's ``tools/dataset/readers/object_detection/pascalvoc.py``.

reference: luminoth/tools/dataset/readers/object_detection/pascalvoc.py.
Directory contract: ``data_dir/ImageSets/Main/{split}.txt`` listing image
ids, ``data_dir/Annotations/{id}.xml`` and ``data_dir/JPEGImages/{id}.jpg``.
"""

import logging
import os

from luminoth_tpu_torch.tools.dataset.readers import (
    InvalidDataDirectory,
    ObjectDetectionReader,
)
from luminoth_tpu_torch.utils.dataset import read_image_bytes, read_xml

logger = logging.getLogger(__name__)


class PascalVOCReader(ObjectDetectionReader):
    def __init__(self, data_dir, split, **kwargs):
        super().__init__(**kwargs)
        self._data_dir = data_dir
        self._split = split
        self._classes_cache = None

        self._imagesets_path = os.path.join(data_dir, "ImageSets", "Main")
        self._images_path = os.path.join(data_dir, "JPEGImages")
        self._annotations_path = os.path.join(data_dir, "Annotations")

        split_file = os.path.join(self._imagesets_path, f"{split}.txt")
        if not os.path.exists(split_file):
            raise InvalidDataDirectory(
                f'Split file not found: "{split_file}"'
            )
        with open(split_file) as f:
            self._image_ids = [
                line.strip().split()[0] for line in f if line.strip()
            ]

    def get_total(self):
        return len(self._image_ids)

    def get_classes(self):
        """Class list, from the per-class ImageSets listings when present.

        VOC ships ``ImageSets/Main/<class>_<split>.txt`` files; reading
        their names is O(#classes) (reference: pascalvoc.py:30-37, same
        semantics: a class annotated in the XMLs but missing its
        ImageSets listing is NOT part of the class set and its boxes are
        skipped — use ``--only-classes`` or add the listing to include
        it). Only VOC-style datasets without per-class listings fall
        back to the O(dataset) scan of every annotation XML.
        """
        if self._classes_cache is not None:
            return self._classes_cache
        suffix = f"_{self._split}.txt"
        classes = sorted(
            name[: -len(suffix)]
            for name in os.listdir(self._imagesets_path)
            if name.endswith(suffix)
        )
        if not classes:
            found = set()
            for image_id in self._image_ids:
                annotation = self._annotation_for(image_id)
                if annotation is None:
                    continue
                for obj in annotation.get("object", []):
                    found.add(obj["name"])
            classes = sorted(found)
        self._classes_cache = classes
        return classes

    def _annotation_for(self, image_id):
        path = os.path.join(self._annotations_path, f"{image_id}.xml")
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

            image_file = annotation.get("filename") or f"{image_id}.jpg"
            image_path = os.path.join(self._images_path, image_file)
            if not os.path.exists(image_path):
                self.errors += 1
                continue

            size = annotation.get("size", {})
            record = {
                "width": int(float(size.get("width", 0))),
                "height": int(float(size.get("height", 0))),
                "depth": int(float(size.get("depth", 3))),
                "filename": image_file,
                "image_raw": read_image_bytes(image_path),
                "gt_boxes": gt_boxes,
            }
            self._will_add_record(record)
            self.yielded_records += 1
            yield record
