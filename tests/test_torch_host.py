"""The port's copies of the JAX package's host code against their originals.

``luminoth_tpu_torch`` keeps its own copy of every host module it uses
(config resolution, image preprocessing, the TFRecord and SequenceExample
codecs with their native C helpers, the dataset readers and the
multi-process loader, the numpy box geometry of eval, image reading and
drawing, the web page). Each case runs the same inputs, made from a seed
with numpy, through the JAX package's module and the port's copy, and
asserts that the results are equal: these are copies, so no tolerance.
"""

import io
import os

import numpy as np
import pytest
import yaml
from PIL import Image

import luminoth_tpu
from luminoth_tpu import io as jax_io
from luminoth_tpu import vis as jax_vis
from luminoth_tpu.datasets import ObjectDetectionDataset as JaxDataset
from luminoth_tpu.datasets import object_detection_dataset as jax_odd
from luminoth_tpu.formats import crc32c as jax_crc
from luminoth_tpu.formats import example_pb as jax_pb
from luminoth_tpu.formats import native_example as jax_native
from luminoth_tpu.formats import tfrecord as jax_tfrecord
from luminoth_tpu.ops import np_boxes as jax_np_boxes
from luminoth_tpu.utils import config as jax_config
from luminoth_tpu.utils import image as jax_image
import luminoth_tpu_torch
from luminoth_tpu_torch import io as port_io
from luminoth_tpu_torch import vis
from luminoth_tpu_torch.datasets import ObjectDetectionDataset
from luminoth_tpu_torch.datasets import object_detection_dataset as odd
from luminoth_tpu_torch.formats import crc32c, example_pb, native_example
from luminoth_tpu_torch.formats import tfrecord
from luminoth_tpu_torch.ops import np_boxes
from luminoth_tpu_torch.utils import config
from luminoth_tpu_torch.utils import image
from test_torch_isolation import few_threads  # noqa: F401

PACKAGES = {
    "jax": {"pb": jax_pb, "tfrecord": jax_tfrecord},
    "port": {"pb": example_pb, "tfrecord": tfrecord},
}
AUGMENTATION = [
    {"flip": {"left_right": True, "up_down": True, "prob": 0.5}},
    {"patch": {"min_height": 40, "min_width": 50, "prob": 0.7}},
    {"resize": {"min_size": 50, "max_size": 90, "prob": 0.5}},
    {"distortion": {"brightness": {"max_delta": 0.2},
                    "contrast": {"lower": 0.8, "upper": 1.2},
                    "hue": {"max_delta": 0.1},
                    "saturation": {"lower": 0.8, "upper": 1.2},
                    "prob": 0.8}},
    {"expand": {"fill": 127, "min_ratio": 1, "max_ratio": 2, "prob": 0.5}},
]


def jpeg_record(rng, pb, index, height=48, width=64):
    """One SequenceExample of a noise JPEG with 1-4 labelled boxes."""
    pixels = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="JPEG", quality=90)
    n = int(rng.integers(1, 5))
    x1 = rng.integers(0, width // 2, n)
    y1 = rng.integers(0, height // 2, n)
    boxes = np.stack([x1, y1, x1 + rng.integers(4, width // 2, n),
                      y1 + rng.integers(4, height // 2, n),
                      rng.integers(0, 5, n)], -1)
    lists = {name: [[int(v)] for v in boxes[:, col]]
             for col, name in enumerate(("xmin", "ymin", "xmax", "ymax",
                                         "label"))}
    return pb.encode_sequence_example(
        {"image_raw": buf.getvalue(), "filename": f"img{index}.jpg".encode(),
         "width": width, "height": height, "depth": 3},
        lists,
    )


def write_records(directory, count, seed, package="jax"):
    mods = PACKAGES[package]
    rng = np.random.default_rng(seed)
    path = os.path.join(directory, "train.tfrecords")
    records = [jpeg_record(rng, mods["pb"], i) for i in range(count)]
    with mods["tfrecord"].TFRecordWriter(path) as writer:
        for record in records:
            writer.write(record)
    return path, records


def dataset_config(module, data_dir, augment, transfer, workers):
    return module.Config({
        "train": {"batch_size": 2, "num_epochs": 2, "seed": 3,
                  "random_shuffle": True},
        "dataset": {
            "type": "object_detection", "dir": data_dir, "split": "train",
            "image_preprocessing": {"min_size": 40, "max_size": 80,
                                    "canvas_height": 96,
                                    "canvas_width": 64},
            "max_gt_boxes": 6, "transfer_dtype": transfer,
            "num_worker_processes": workers,
            "data_augmentation": AUGMENTATION if augment else [],
        },
    })


class TestConfig:
    def test_base_configs_equal(self):
        jax_base = jax_config.load_config_files([os.path.join(
            os.path.dirname(luminoth_tpu.__file__), "models", "fasterrcnn",
            "base_config.yml")])
        assert config.to_plain(config.get_base_config("fasterrcnn")) == (
            jax_config.to_plain(jax_base))

    @pytest.mark.parametrize("custom, overrides", [
        ({}, None),
        ({"train": {"batch_size": 4, "learning_rate": {
            "_replace": True, "decay_method": "piecewise_constant",
            "boundaries": [10, 20], "values": [0.1, 0.01, 0.001]}}},
         None),
        ({"model": {"network": {"num_classes": 80}}},
         ["train.seed=7", "model.rpn.proposals.pre_nms_top_n=600",
          "dataset.image_preprocessing.resize_method=tf1",
          "train.optimizer.momentum=0.5", "model.base_network.weights=none"]),
        ({"dataset": {"image_preprocessing": {"canvas_height": 608,
                                              "canvas_width": 800}},
          "train": {"optimizer": {"_replace": True, "type": "adam"}}},
         ["train.debug=true", "dataset.max_gt_boxes=32"]),
    ], ids=["base", "replace_subtree", "overrides", "replace_and_overrides"])
    def test_resolution(self, tmp_path, custom, overrides):
        custom = {"model": {"type": "fasterrcnn", **custom.get("model", {})},
                  **{k: v for k, v in custom.items() if k != "model"}}
        path = tmp_path / "custom.yml"
        path.write_text(yaml.safe_dump(custom))
        got = config.get_config([str(path)], overrides)
        want = jax_config.get_config([str(path)], overrides)
        assert isinstance(got, config.Config)
        assert config.to_plain(got) == jax_config.to_plain(want)
        assert config.dump_config(got) == jax_config.dump_config(want)

    @pytest.mark.parametrize("custom", [
        {"train": {"batch_size": "eight"}},
        {"train": {"random_shuffle": 1}},
    ], ids=["str_for_int", "int_for_bool"])
    def test_type_errors_alike(self, tmp_path, custom):
        path = tmp_path / "custom.yml"
        path.write_text(yaml.safe_dump({"model": {"type": "fasterrcnn"},
                                        **custom}))
        with pytest.raises(ValueError) as got:
            config.get_config([str(path)])
        with pytest.raises(ValueError) as want:
            jax_config.get_config([str(path)])
        assert str(got.value) == str(want.value)

    @pytest.mark.parametrize("options", [
        ["a.b=none", "a.c=True", "a.d=3", "e=1e-4", "f.g.h=word"],
        ["x=1", "x=2"],
    ])
    def test_parse_override(self, options):
        assert config.parse_override(options) == (
            jax_config.parse_override(options))


class TestImage:
    @pytest.mark.parametrize("augment", [False, True],
                             ids=["plain", "augmented"])
    @pytest.mark.parametrize("dtype", [np.uint8, np.float32])
    @pytest.mark.parametrize("prep", [
        {"min_size": 40, "max_size": 80},
        {"fixed_height": 56, "fixed_width": 72},
        {"min_size": 30, "max_size": 70, "resize_method": "tf1"},
    ], ids=["min_max", "fixed", "tf1"])
    def test_preprocess_image(self, augment, dtype, prep):
        rng = np.random.default_rng(11)
        pixels = rng.integers(0, 256, (60, 90, 3)).astype(dtype)
        bboxes = np.array([[5, 6, 40, 50, 1], [30, 10, 80, 55, 3]],
                          np.float32)
        cfg = {"dataset": {"image_preprocessing": prep,
                           "data_augmentation": AUGMENTATION}}
        for seed in range(4):
            got = odd.preprocess_image(
                config.Config(cfg), pixels.copy(), bboxes.copy(),
                rng=np.random.RandomState(seed), augment=augment)
            want = jax_odd.preprocess_image(
                jax_config.Config(cfg), pixels.copy(), bboxes.copy(),
                rng=np.random.RandomState(seed), augment=augment)
            assert got.keys() == want.keys()
            for key in want:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=key)
                assert np.asarray(got[key]).dtype == (
                    np.asarray(want[key]).dtype)

    @pytest.mark.parametrize("shape, canvas", [
        ((40, 50, 3), (64, 64)), ((70, 50, 3), (64, 96)),
        ((64, 64, 3), (64, 64)),
    ])
    @pytest.mark.parametrize("dtype", [np.uint8, np.float64])
    def test_pad_to_canvas(self, shape, canvas, dtype):
        pixels = np.random.default_rng(2).integers(0, 256, shape).astype(dtype)
        got, got_hw = odd.pad_to_canvas(pixels, canvas)
        want, want_hw = jax_odd.pad_to_canvas(pixels, canvas)
        assert got_hw == want_hw and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("prep", [
        {"canvas_height": 600, "canvas_width": 1000},
        {"fixed_height": 300, "fixed_width": 300},
        {"min_size": 600, "max_size": 1000},
        {"min_size": 500},
        {},
    ])
    def test_canvas_shape(self, prep):
        cfg = {"dataset": {"image_preprocessing": prep}}
        assert odd.canvas_shape(config.Config(cfg)) == (
            jax_odd.canvas_shape(jax_config.Config(cfg)))

    @pytest.mark.parametrize("shape, canvas", [
        ((90, 60, 3), (64, 96)), ((50, 40, 3), (64, 64)),
        ((120, 200, 3), (96, 64)),
    ])
    @pytest.mark.parametrize("scale", [1.5, (0.5, 0.75)])
    def test_fit_to_canvas_and_compose_scale(self, shape, canvas, scale):
        pixels = np.random.default_rng(5).random(shape).astype(np.float32)
        bboxes = np.array([[4, 5, 30, 40, 2]], np.float32)
        got = image.fit_to_canvas(pixels, canvas, bboxes=bboxes)
        want = jax_image.fit_to_canvas(pixels, canvas, bboxes=bboxes)
        assert got.keys() == want.keys() and got["scale"] == want["scale"]
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["bboxes"], want["bboxes"])
        assert image.compose_scale(scale, got["scale"]) == (
            jax_image.compose_scale(scale, want["scale"]))


class TestRecords:
    @pytest.mark.parametrize("writer, reader", [("jax", "port"),
                                                ("port", "jax")])
    def test_tfrecord_across_packages(self, tmp_path, writer, reader):
        path, records = write_records(str(tmp_path), 5, seed=1,
                                      package=writer)
        read = list(PACKAGES[reader]["tfrecord"].read_tfrecords(
            path, verify=True))
        assert read == records
        # A flipped payload byte must fail the reader's CRC check.
        data = bytearray(open(path, "rb").read())
        data[40] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(data))
        with pytest.raises(Exception):
            list(PACKAGES[reader]["tfrecord"].read_tfrecords(path,
                                                             verify=True))

    @pytest.mark.parametrize("size", [0, 1, 31, 4096])
    def test_crc32c_equal(self, size):
        data = np.random.default_rng(size).bytes(size)
        assert crc32c.crc32c(data) == jax_crc.crc32c(data)
        assert crc32c.masked_crc32c(data) == jax_crc.masked_crc32c(data)

    @pytest.mark.parametrize("seed", range(3))
    def test_native_parser_against_python_codec(self, seed):
        assert native_example.native_available()
        rng = np.random.default_rng(seed)
        for index in range(4):
            record = jpeg_record(rng, example_pb, index)
            got = native_example.parse_od_record(record)
            assert got is not None
            image_bytes, bboxes, filename, _ = got
            context, lists = jax_pb.decode_sequence_example(record)
            assert image_bytes == context["image_raw"][0]
            assert filename == context["filename"][0].decode()
            want = np.array([[lists[k][i][0] for k in
                              ("xmin", "ymin", "xmax", "ymax", "label")]
                             for i in range(len(lists["label"]))],
                            np.float32)
            np.testing.assert_array_equal(bboxes, want)
            jax_parsed = jax_native.parse_od_record(record)
            assert jax_parsed[0] == image_bytes
            np.testing.assert_array_equal(jax_parsed[1], bboxes)
            assert example_pb.decode_sequence_example(record) == (
                context, lists)


class TestDataset:
    @pytest.mark.parametrize("augment, transfer, workers", [
        (False, "float32", 0),
        (True, "float32", 0),
        (True, "uint8", 0),
        (True, "uint8", 1),
    ], ids=["plain", "augmented", "augmented_uint8", "worker_process"])
    def test_batches_equal(self, tmp_path, augment, transfer, workers):
        write_records(str(tmp_path), 7, seed=4)
        got = list(ObjectDetectionDataset(dataset_config(
            config, str(tmp_path), augment, transfer, workers)))
        want = list(JaxDataset(dataset_config(
            jax_config, str(tmp_path), augment, transfer, workers)))
        # 2 epochs of 7 records in batches of 2: one stream in process,
        # while a worker process drops each epoch's remainder.
        assert len(got) == len(want) == (6 if workers else 7)
        for got_batch, want_batch in zip(got, want):
            assert got_batch.keys() == want_batch.keys()
            for key, value in want_batch.items():
                if isinstance(value, np.ndarray):
                    assert got_batch[key].dtype == value.dtype, key
                    np.testing.assert_array_equal(got_batch[key], value,
                                                  err_msg=key)
                else:
                    assert got_batch[key] == value, key


class TestEvalAndServingHost:
    @pytest.mark.parametrize("name", ["bbox_overlap", "clip_boxes",
                                      "encode", "decode", "nms", "unmap"])
    def test_np_boxes_equal(self, name):
        rng = np.random.default_rng(5)
        xy = rng.uniform(-10, 100, (30, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(1, 60, (30, 2))], 1)
        other = boxes[::-1] * 1.1 + rng.normal(0, 5, (30, 1))
        args = {
            "bbox_overlap": (boxes, other[:7]),
            "clip_boxes": (boxes, (64, 80)),
            "encode": (boxes, other, [0.1, 0.2]),
            "decode": (boxes, rng.normal(0, 0.3, boxes.shape)),
            "nms": (boxes, rng.uniform(size=30), 0.4),
            "unmap": (boxes[:5], 30, [3, 1, 9, 12, 29], -1),
        }[name]
        got = getattr(np_boxes, name)(*args)
        want = getattr(jax_np_boxes, name)(*args)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    def test_read_image_and_vis_objects_equal(self, tmp_path):
        rng = np.random.default_rng(6)
        path = tmp_path / "a.png"
        Image.fromarray(rng.integers(0, 256, (40, 50, 4), dtype=np.uint8),
                        "RGBA").save(path)
        image = port_io.read_image(str(path))
        np.testing.assert_array_equal(image, jax_io.read_image(str(path)))
        objects = [{"bbox": [3, 4, 30, 25], "label": "cat", "prob": 0.91},
                   {"bbox": [10.4, 2.6, 44.5, 39], "label": 2}]
        for kwargs in ({}, {"fill": True, "scale": 2}, {"labels": False}):
            np.testing.assert_array_equal(
                np.asarray(vis.vis_objects(image, objects, **kwargs)),
                np.asarray(jax_vis.vis_objects(image, objects, **kwargs)))

    def test_web_page_equal(self):
        page = "tools/server/templates/index.html"
        with open(os.path.join(luminoth_tpu_torch.__path__[0], page),
                  "rb") as got, open(os.path.join(luminoth_tpu.__path__[0],
                                                  page), "rb") as want:
            assert got.read() == want.read()
