"""Open Images reader (CSV annotations + threaded image fetching).

A copy of the JAX package's ``tools/dataset/readers/object_detection/openimages.py``.

reference: luminoth/tools/dataset/readers/object_detection/openimages.py
(CSV annotation parsing; threaded S3 image download with a work queue,
:33-40). Directory contract: ``data_dir/{split}/annotations-human-bbox.csv``
(or ``{split}-annotations-bbox.csv`` in data_dir) with normalized
coordinates, plus ``class-descriptions.csv`` mapping label ids to names.

Images are read from a local ``data_dir/{split}/images`` (or ``images``)
directory when present; otherwise they are downloaded from the Open Images
S3 bucket with a pool of worker threads (network permitting).
"""

import csv
import logging
import os
import queue
import threading

from luminoth_tpu_torch.tools.dataset.readers import (
    InvalidDataDirectory,
    ObjectDetectionReader,
)
from luminoth_tpu_torch.utils.dataset import image_size

logger = logging.getLogger(__name__)

IMAGE_URL_FORMAT = (
    "https://open-images-dataset.s3.amazonaws.com/{split}/{image_id}.jpg"
)
NUM_DOWNLOAD_THREADS = 25


class OpenImagesReader(ObjectDetectionReader):
    def __init__(self, data_dir, split, download_threads=NUM_DOWNLOAD_THREADS,
                 **kwargs):
        super().__init__(**kwargs)
        self._data_dir = data_dir
        self._split = split
        self._download_threads = download_threads

        ann_candidates = [
            os.path.join(data_dir, split, "annotations-human-bbox.csv"),
            os.path.join(data_dir, f"{split}-annotations-bbox.csv"),
            os.path.join(data_dir, split, f"{split}-annotations-bbox.csv"),
        ]
        self._annotations_path = next(
            (p for p in ann_candidates if os.path.exists(p)), None
        )
        if self._annotations_path is None:
            raise InvalidDataDirectory(
                f"Could not find Open Images annotations for split {split}"
            )

        desc_candidates = [
            os.path.join(data_dir, "class-descriptions.csv"),
            os.path.join(data_dir, "class-descriptions-boxable.csv"),
        ]
        self._label_names = {}
        for path in desc_candidates:
            if os.path.exists(path):
                with open(path, newline="") as f:
                    for row in csv.reader(f):
                        if len(row) >= 2:
                            self._label_names[row[0]] = row[1]
                break

        self._annotations_by_image = {}
        with open(self._annotations_path, newline="") as f:
            for row in csv.DictReader(f):
                self._annotations_by_image.setdefault(
                    row["ImageID"], []
                ).append(row)

        self._image_dirs = [
            os.path.join(data_dir, split, "images"),
            os.path.join(data_dir, "images", split),
            os.path.join(data_dir, "images"),
        ]

    def get_total(self):
        return len(self._annotations_by_image)

    def get_classes(self):
        return sorted(
            {
                row["LabelName"]
                for rows in self._annotations_by_image.values()
                for row in rows
            }
        )

    def pretty_name(self, label):
        return self._label_names.get(label, label)

    def _local_image(self, image_id):
        for directory in self._image_dirs:
            path = os.path.join(directory, f"{image_id}.jpg")
            if os.path.exists(path):
                return path
        return None

    def _fetch_image(self, image_id):
        """Local file or S3 download; returns raw bytes or None."""
        path = self._local_image(image_id)
        if path is not None:
            with open(path, "rb") as f:
                return f.read()
        try:
            import urllib.request

            url = IMAGE_URL_FORMAT.format(
                split=self._split, image_id=image_id
            )
            with urllib.request.urlopen(url, timeout=60) as resp:
                return resp.read()
        except Exception:
            return None

    def iterate(self):
        """Producer/consumer iteration: worker threads fetch image bytes."""
        work = queue.Queue()
        results = queue.Queue(maxsize=self._download_threads * 2)
        sentinel = object()

        image_ids = [
            i for i in self._annotations_by_image
            if not self._should_skip(i)
        ]
        for image_id in image_ids:
            work.put(image_id)
        for _ in range(self._download_threads):
            work.put(sentinel)

        def worker():
            while True:
                item = work.get()
                if item is sentinel:
                    results.put(sentinel)
                    return
                results.put((item, self._fetch_image(item)))

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self._download_threads)
        ]
        for t in threads:
            t.start()

        stopped = False

        def drain_work_queue():
            # Stop condition reached (limits/quotas met): throw away the
            # queued ids so workers hit their sentinels next — without
            # this, the 25 download threads would keep fetching every
            # remaining image (potentially the whole split) before
            # iterate() could return.
            try:
                while True:
                    item = work.get_nowait()
                    if item is sentinel:
                        work.put(item)  # keep worker shutdown signals
                        break
            except queue.Empty:
                pass

        finished_workers = 0
        while finished_workers < self._download_threads:
            item = results.get()
            if item is sentinel:
                finished_workers += 1
                continue
            image_id, image_raw = item
            if self._stop_iteration():
                if not stopped:
                    stopped = True
                    drain_work_queue()
                continue  # drain in-flight results
            if image_raw is None:
                self.errors += 1
                continue
            try:
                width, height, depth = image_size(image_raw)
            except Exception:
                self.errors += 1
                continue

            gt_boxes = []
            for row in self._annotations_by_image[image_id]:
                label = row["LabelName"]
                if label not in self.classes:
                    continue
                gt_boxes.append(
                    {
                        "label": self.classes.index(label),
                        "xmin": int(float(row["XMin"]) * width),
                        "ymin": int(float(row["YMin"]) * height),
                        "xmax": int(float(row["XMax"]) * width),
                        "ymax": int(float(row["YMax"]) * height),
                    }
                )
            if not gt_boxes:
                continue

            if self._class_examples:
                # Drop records whose labels are ALL already at quota so
                # frequent classes don't over-collect while waiting for
                # the rarest class to fill — OpenImages is the one
                # reader where the reference does this balancing
                # (reference: readers/object_detection/openimages.py:155-165);
                # the other readers only stop once every class maxes out.
                labels_in_image = {
                    self.classes[b["label"]] for b in gt_boxes
                }
                if not labels_in_image - self._maxed_out_classes:
                    continue

            record = {
                "width": width,
                "height": height,
                "depth": depth,
                "filename": f"{image_id}.jpg",
                "image_raw": image_raw,
                "gt_boxes": gt_boxes,
            }
            self._will_add_record(record)
            self.yielded_records += 1
            yield record
