"""Dataset reader framework + registry.

A copy of the JAX package's ``tools/dataset/readers/__init__.py``.

reference: luminoth/tools/dataset/readers/__init__.py:8-24 (registry),
base_reader.py:10-25 (abstract interface),
object_detection/object_detection_reader.py:31-200 (filters, quotas,
record contract).
"""

import abc
from collections import Counter

from luminoth_tpu_torch.datasets.exceptions import InvalidDataDirectory  # noqa: F401


class BaseReader(abc.ABC):
    """Abstract reader: knows its total and iterates records."""

    @property
    @abc.abstractmethod
    def total(self):
        """Total amount of records in the dataset."""

    @abc.abstractmethod
    def iterate(self):
        """Iterate over the records in the dataset."""


class ObjectDetectionReader(BaseReader):
    """Reader contract for object detection.

    Subclasses implement ``get_total``, ``get_classes`` and ``iterate``;
    records are dicts with keys: width, height, depth, filename, image_raw,
    gt_boxes (list of {label, xmin, ymin, xmax, ymax}).

    Supports class whitelists, image whitelists, example limits, and
    per-class quotas with maxed-out tracking.
    """

    def __init__(self, only_classes=None, only_images=None,
                 limit_examples=None, class_examples=None, **kwargs):
        if isinstance(only_classes, str):
            only_classes = only_classes.split(",")
        self._only_classes = only_classes
        if isinstance(only_images, str):
            only_images = only_images.split(",")
        self._only_images = only_images

        self._total = None
        self._classes = None
        self._limit_examples = limit_examples
        self._class_examples = class_examples
        self._per_class_counter = Counter()
        self._maxed_out_classes = set()
        self.yielded_records = 0
        self.errors = 0

    @property
    def total(self):
        if self._total is None:
            self._total = self._filter_total(self.get_total())
        return self._total

    @property
    def classes(self):
        if self._classes is None:
            self._classes = self._filter_classes(self.get_classes())
        return self._classes

    @classes.setter
    def classes(self, classes):
        self._classes = classes

    @abc.abstractmethod
    def get_total(self):
        """Total number of records before filtering."""

    @abc.abstractmethod
    def get_classes(self):
        """List of all the classes available in the dataset."""

    def pretty_name(self, label):
        return label

    def _filter_total(self, original_total):
        if self._only_images:
            return len(self._only_images)
        if self._limit_examples is not None and self._limit_examples > 0:
            return min(self._limit_examples, original_total)
        return original_total

    def _filter_classes(self, original_classes):
        if self._only_classes:
            return sorted(self._only_classes)
        return list(original_classes) if original_classes else None

    def _should_skip(self, image_id):
        return (
            self._only_images is not None
            and image_id is not None
            and image_id not in self._only_images
        )

    def _all_maxed_out(self):
        return (
            self._class_examples is not None
            and len(self._maxed_out_classes) == len(self.classes)
        )

    def _stop_iteration(self):
        return self.yielded_records == self.total or self._all_maxed_out()

    def _will_add_record(self, record):
        for box in record["gt_boxes"]:
            self._per_class_counter[self.classes[box["label"]]] += 1
        if self._class_examples is not None:
            self._maxed_out_classes |= {
                label
                for label, count in self._per_class_counter.items()
                if count >= self._class_examples
            }


def get_reader(reader):
    reader = reader.lower()
    if reader not in READERS:
        raise ValueError('"{}" is not a valid reader'.format(reader))
    return READERS[reader]


def _lazy_readers():
    from luminoth_tpu_torch.tools.dataset.readers.object_detection.pascalvoc import (
        PascalVOCReader,
    )
    from luminoth_tpu_torch.tools.dataset.readers.object_detection.coco import (
        COCOReader,
    )
    from luminoth_tpu_torch.tools.dataset.readers.object_detection.csv_reader import (
        CSVReader,
    )
    from luminoth_tpu_torch.tools.dataset.readers.object_detection.flat_reader import (
        FlatReader,
    )
    from luminoth_tpu_torch.tools.dataset.readers.object_detection.imagenet import (
        ImageNetReader,
    )
    from luminoth_tpu_torch.tools.dataset.readers.object_detection.openimages import (
        OpenImagesReader,
    )
    from luminoth_tpu_torch.tools.dataset.readers.object_detection.taggerine import (
        TaggerineReader,
    )

    return {
        "coco": COCOReader,
        "csv": CSVReader,
        "flat": FlatReader,
        "imagenet": ImageNetReader,
        "openimages": OpenImagesReader,
        "pascal": PascalVOCReader,
        "taggerine": TaggerineReader,
    }


class _LazyReaders(dict):
    def _ensure(self):
        if not super().__len__():
            super().update(_lazy_readers())

    def __getitem__(self, key):
        self._ensure()
        return super().__getitem__(key)

    def __contains__(self, key):
        self._ensure()
        return super().__contains__(key)

    def keys(self):
        self._ensure()
        return super().keys()

    def __iter__(self):
        self._ensure()
        return super().__iter__()


READERS = _LazyReaders()
