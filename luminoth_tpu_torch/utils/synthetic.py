"""Synthetic object-detection data for smoke runs of the training loop and
of ``lumi dataset``.

:func:`write_synthetic_records` writes ``<directory>/<split>.tfrecords``
(uniform-noise JPEGs with random labelled boxes, in the SequenceExample
layout the dataset readers parse) and ``classes.json``. The records are
encoded by the port's TFRecord writer (``formats/``, a copy of the JAX
package's), which the port's dataset readers parse.

:func:`write_annotation_tree` lays out the same kind of images and boxes
as raw annotations in the directory layout of one of ``dataset
transform``'s seven ``--type`` readers, images on disk (nothing for the
OpenImages reader to download).
"""

import csv
import io
import json
import os

import numpy as np
from PIL import Image

from luminoth_tpu_torch.formats.example_pb import encode_sequence_example
from luminoth_tpu_torch.formats.tfrecord import TFRecordWriter


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


ANNOTATION_FORMATS = ("coco", "csv", "flat", "imagenet", "openimages",
                      "pascal", "taggerine")


def _snap(values, size):
    """Round pixel coordinates to multiples of ``size`` over its largest
    power-of-two factor, so that ``value / size`` is a binary fraction and
    the OpenImages reader, which scales normalized coordinates back, gets
    them exactly (a size of 48 gives multiples of 3)."""
    step = size // (size & -size)
    return [int(step * round(v / step)) for v in values]


def _save_jpeg(path, image):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    mode = "L" if image.ndim == 2 else "RGB"
    Image.fromarray(image, mode).save(path, format="JPEG", quality=90)


def _voc_xml(filename, width, height, depth, boxes, names):
    objects = "".join(
        f"<object><name>{name}</name><difficult>0</difficult><bndbox>"
        f"<xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax>"
        f"<ymax>{y2}</ymax></bndbox></object>"
        for (x1, y1, x2, y2), name in zip(boxes, names))
    return (f"<annotation><filename>{filename}</filename><size>"
            f"<width>{width}</width><height>{height}</height>"
            f"<depth>{depth}</depth></size>{objects}</annotation>")


def write_annotation_tree(root, fmt, count, seed, classes, split="train",
                          height=48, width=64, boxes_per_image=(1, 4),
                          grayscale=(), class_listings=True):
    """Write ``count`` noise JPEGs of ``height``x``width`` with boxes drawn
    from ``seed`` over the class names ``classes``, as ``fmt``'s raw
    annotations of ``split`` under ``root``.

    ``grayscale``: indices of the images saved as one-channel JPEGs.
    ``class_listings``: Pascal VOC's ``ImageSets/Main/<class>_<split>.txt``
    files (without them the reader scans every XML for its classes).
    Calls with other splits may share ``root``: file names carry the split.

    Returns a list of ``(filename, boxes, names)``, one per image in the
    order written: the file name the reader puts in the record, the
    (n, 4) ``x1 y1 x2 y2`` pixel boxes and their n class names.
    """
    if fmt not in ANNOTATION_FORMATS:
        raise ValueError(f"unknown annotation format {fmt!r}")
    rng = np.random.default_rng(seed)
    low, high = boxes_per_image
    images = []
    for i in range(count):
        gray = i in grayscale
        shape = (height, width) if gray else (height, width, 3)
        image = rng.integers(0, 256, shape, dtype=np.uint8)
        drawn = random_boxes(rng, int(rng.integers(low, high + 1)), height,
                             width, len(classes))
        boxes = drawn[:, :4]
        if fmt == "openimages":
            boxes = np.stack([_snap(boxes[:, 0], width),
                              _snap(boxes[:, 1], height),
                              _snap(boxes[:, 2], width),
                              _snap(boxes[:, 3], height)], -1)
        names = [classes[int(c)] for c in drawn[:, 4]]
        images.append((f"{split}_{i:04d}", image, boxes, names))

    written = []
    if fmt == "pascal":
        main = os.path.join(root, "ImageSets", "Main")
        os.makedirs(main, exist_ok=True)
        os.makedirs(os.path.join(root, "Annotations"), exist_ok=True)
        for image_id, image, boxes, names in images:
            filename = f"{image_id}.jpg"
            _save_jpeg(os.path.join(root, "JPEGImages", filename), image)
            depth = 1 if image.ndim == 2 else 3
            with open(os.path.join(root, "Annotations", f"{image_id}.xml"),
                      "w") as f:
                f.write(_voc_xml(filename, width, height, depth,
                                 boxes.tolist(), names))
            written.append((filename, boxes, names))
        with open(os.path.join(main, f"{split}.txt"), "w") as f:
            f.writelines(f"{image_id}\n" for image_id, *_ in images)
        if class_listings:
            for name in classes:
                with open(os.path.join(main, f"{name}_{split}.txt"),
                          "w") as f:
                    f.writelines(
                        f"{image_id} {1 if name in names else -1}\n"
                        for image_id, _, _, names in images)
    elif fmt == "imagenet":
        for image_id, image, boxes, names in images:
            filename = f"{image_id}.JPEG"
            _save_jpeg(os.path.join(root, "Data", "DET", split, filename),
                       image)
            xml = os.path.join(root, "Annotations", "DET", split,
                               f"{image_id}.xml")
            os.makedirs(os.path.dirname(xml), exist_ok=True)
            with open(xml, "w") as f:
                f.write(_voc_xml(image_id, width, height, 3,
                                 boxes.tolist(), names))
            written.append((filename, boxes, names))
        sets = os.path.join(root, "ImageSets", "DET")
        os.makedirs(sets, exist_ok=True)
        with open(os.path.join(sets, f"{split}.txt"), "w") as f:
            f.writelines(f"{image_id} {i + 1}\n"
                         for i, (image_id, *_) in enumerate(images))
        devkit = os.path.join(root, "devkit", "data")
        os.makedirs(devkit, exist_ok=True)
        with open(os.path.join(devkit, "map_det.txt"), "w") as f:
            f.writelines(f"{name} {i + 1} synset {i}\n"
                         for i, name in enumerate(classes))
    elif fmt == "coco":
        data = {"images": [], "annotations": [], "categories": [
            {"id": i + 1, "name": name, "supercategory": "thing"}
            for i, name in enumerate(classes)]}
        for n, (image_id, image, boxes, names) in enumerate(images):
            filename = f"{image_id}.jpg"
            _save_jpeg(os.path.join(root, split, filename), image)
            data["images"].append({"id": n + 1, "file_name": filename,
                                   "width": width, "height": height})
            for (x1, y1, x2, y2), name in zip(boxes.tolist(), names):
                data["annotations"].append({
                    "id": len(data["annotations"]) + 1, "image_id": n + 1,
                    "category_id": classes.index(name) + 1,
                    "bbox": [x1, y1, x2 - x1, y2 - y1], "iscrowd": 0})
            written.append((filename, boxes, names))
        os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
        with open(os.path.join(root, "annotations",
                               f"instances_{split}.json"), "w") as f:
            json.dump(data, f)
    elif fmt == "csv":
        rows = []
        for image_id, image, boxes, names in images:
            _save_jpeg(os.path.join(root, split, f"{image_id}.jpg"), image)
            rows += [[image_id, *box, name]
                     for box, name in zip(boxes.tolist(), names)]
            written.append((f"{image_id}.jpg", boxes, names))
        os.makedirs(root, exist_ok=True)
        with open(os.path.join(root, f"{split}.csv"), "w", newline="") as f:
            out = csv.writer(f)
            out.writerow(["image_id", "xmin", "ymin", "xmax", "ymax",
                          "label"])
            out.writerows(rows)
    elif fmt == "flat":
        for image_id, image, boxes, names in images:
            filename = f"{image_id}.jpg"
            _save_jpeg(os.path.join(root, split, filename), image)
            with open(os.path.join(root, split, f"{image_id}.json"),
                      "w") as f:
                json.dump({"rects": [
                    {"x1": x1, "y1": y1, "x2": x2, "y2": y2, "label": name}
                    for (x1, y1, x2, y2), name in zip(boxes.tolist(),
                                                      names)]}, f)
            written.append((filename, boxes, names))
    elif fmt == "taggerine":
        labels = {}
        for image_id, image, boxes, names in images:
            filename = f"{image_id}.jpg"
            _save_jpeg(os.path.join(root, split, filename), image)
            labels[filename] = [
                {"x_min": x1, "y_min": y1, "x_max": x2, "y_max": y2,
                 "label": name}
                for (x1, y1, x2, y2), name in zip(boxes.tolist(), names)]
            written.append((filename, boxes, names))
        with open(os.path.join(root, split, "labels.json"), "w") as f:
            json.dump(labels, f)
    else:  # openimages: normalized coordinates, label ids, local images
        label_ids = {name: f"/m/{i:05d}" for i, name in enumerate(classes)}
        rows = []
        for image_id, image, boxes, names in images:
            _save_jpeg(os.path.join(root, split, "images",
                                    f"{image_id}.jpg"), image)
            rows += [[image_id, "xclick", label_ids[name], 1,
                      repr(x1 / width), repr(x2 / width),
                      repr(y1 / height), repr(y2 / height)]
                     for (x1, y1, x2, y2), name in zip(boxes.tolist(),
                                                       names)]
            written.append((f"{image_id}.jpg", boxes,
                            [label_ids[name] for name in names]))
        with open(os.path.join(root, split, "annotations-human-bbox.csv"),
                  "w", newline="") as f:
            out = csv.writer(f)
            out.writerow(["ImageID", "Source", "LabelName", "Confidence",
                          "XMin", "XMax", "YMin", "YMax"])
            out.writerows(rows)
        with open(os.path.join(root, "class-descriptions.csv"), "w",
                  newline="") as f:
            csv.writer(f).writerows(
                [label_ids[name], name] for name in classes)
    return written
