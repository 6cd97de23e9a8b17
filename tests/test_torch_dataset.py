"""The port's ``lumi dataset`` (transform, merge, the seven readers, the
writer) and run journal against the JAX package's, on the CPU.

Trees of raw annotations come from ``utils/synthetic.write_annotation_tree``
(noise JPEGs and boxes from a numpy seed, one grayscale image). Both
packages' ``transform`` read the same tree through ``CliRunner``: the
records must be byte-equal (OpenImages fetches its images on threads, so
its records are compared as a multiset), and ``classes.json``, the
per-class composition and the exit codes equal. Then the slice: the
port's records train a small model for 2 steps through ``train.run`` and
``evaluate_once`` scores its checkpoint; the run's journal line equals
the JAX ``save_run``'s. No JAX model is built here.
"""

import json
import os

import numpy as np
import pytest
from click.testing import CliRunner

from luminoth_tpu.datasets.object_detection_dataset import (
    ObjectDetectionDataset as JaxDataset,
)
from luminoth_tpu.tools.dataset import dataset as jax_dataset
from luminoth_tpu.tools.dataset.writers import object_detection_writer as jw
from luminoth_tpu.utils import experiments as jax_experiments
from luminoth_tpu.utils.config import get_config as jax_get_config
from luminoth_tpu_torch import eval as port_eval
from luminoth_tpu_torch import train as trainer
from luminoth_tpu_torch.cli import cli
from luminoth_tpu_torch.datasets import ObjectDetectionDataset
from luminoth_tpu_torch.datasets.object_detection_dataset import parse_record
from luminoth_tpu_torch.formats.example_pb import decode_sequence_example
from luminoth_tpu_torch.formats.tfrecord import read_tfrecords
from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN
from luminoth_tpu_torch.tools.dataset import dataset as port_dataset
from luminoth_tpu_torch.tools.dataset.readers import get_reader
from luminoth_tpu_torch.tools.dataset.writers import (
    object_detection_writer as pw,
)
from luminoth_tpu_torch.utils import experiments, homedir
from luminoth_tpu_torch.utils.checkpoint_io import load_model_weights
from luminoth_tpu_torch.utils.config import get_config
from luminoth_tpu_torch.utils.predicting import load_checkpoint_variables
from luminoth_tpu_torch.utils.synthetic import (
    ANNOTATION_FORMATS,
    write_annotation_tree,
)
from luminoth_tpu_torch.version import __version__
from test_torch_isolation import few_threads, lumi_home_isolation  # noqa: F401

CLASSES = ["bird", "cat", "dog"]
IMAGES = 4  # 48x64 JPEGs, 1-4 boxes each; image 1 grayscale
GRAY = (1,)


def tree(root, fmt, seed=0, split="train", classes=CLASSES, **kwargs):
    """``fmt``'s raw annotations of ``split`` under ``root``; returns what
    was written (``write_annotation_tree``)."""
    return write_annotation_tree(str(root), fmt, IMAGES, seed, classes,
                                 split=split, grayscale=GRAY, **kwargs)


def echoed(output):
    """What the command echoed, without the log lines that
    ``logging.basicConfig`` routes to the first runner's stream."""
    return [line for line in output.splitlines()
            if not line.startswith(("DEBUG:", "INFO:", "WARNING:", "ERROR:"))
            and "Logging error" not in line]


def transform_both(root, tmp_path, args):
    """``dataset transform <args> --data-dir root`` through both packages'
    group, each into its own output directory; returns ``{package:
    (result, output directory)}``."""
    out = {}
    for name, group in (("jax", jax_dataset), ("port", port_dataset)):
        directory = tmp_path / f"out_{name}"
        result = CliRunner().invoke(group, [
            "transform", "--data-dir", str(root), "--output-dir",
            str(directory), *args])
        out[name] = (result, directory)
    return out


def records(path, multiset=False):
    found = list(read_tfrecords(str(path)))
    return sorted(found) if multiset else found


def assert_same_output(out, splits=("train",), multiset=False):
    (jax_result, jax_dir), (port_result, port_dir) = out["jax"], out["port"]
    assert port_result.exit_code == jax_result.exit_code == 0, (
        port_result.output)
    got, want = echoed(port_result.output), echoed(jax_result.output)
    if multiset:  # ties in the composition follow the threads' order
        got, want = sorted(got), sorted(want)
    assert got == want
    for split in splits:
        port_records = records(port_dir / f"{split}.tfrecords", multiset)
        assert port_records == records(jax_dir / f"{split}.tfrecords",
                                       multiset), split
    assert (port_dir / "classes.json").read_text() == (
        jax_dir / "classes.json").read_text()
    return port_dir


def read_back(directory, split="train"):
    """``{filename: (image, (n, 5) boxes)}`` through the port's parser."""
    out = {}
    for record in read_tfrecords(str(directory / f"{split}.tfrecords")):
        image, boxes, filename = parse_record(record)
        out[filename] = (image, boxes)
    return out


def annotated(written, classes):
    """``{filename: (n, 5) boxes}`` of a tree, labels indexed in
    ``classes``."""
    return {filename: np.concatenate(
        [boxes, [[classes.index(n)] for n in names]], 1).astype(np.float32)
        for filename, boxes, names in written}


# ------------------------------------------------------------ the readers


@pytest.mark.parametrize("fmt", ANNOTATION_FORMATS)
def test_transform_equals_jax(fmt, tmp_path):
    """Each reader: byte-equal records, equal ``classes.json`` and
    composition; the records read back to the tree's boxes and labels,
    the grayscale image as one channel in the record and three after
    decoding."""
    written = tree(tmp_path / "tree", fmt)
    port_dir = assert_same_output(
        transform_both(tmp_path / "tree", tmp_path,
                       ["--type", fmt, "--split", "train"]),
        multiset=fmt == "openimages")
    classes = json.loads((port_dir / "classes.json").read_text())
    back = read_back(port_dir)
    want = annotated(written, classes)
    assert sorted(back) == sorted(want)
    for filename, (image, boxes) in back.items():
        np.testing.assert_array_equal(boxes, want[filename], filename)
        assert image.shape == (48, 64, 3)
    depths = {}
    for record in read_tfrecords(str(port_dir / "train.tfrecords")):
        context, _ = decode_sequence_example(record)
        depths[context["filename"][0].decode()] = context["depth"][0]
    gray = written[GRAY[0]][0]
    if fmt in ("coco", "imagenet"):  # depth from the annotations: 3
        assert set(depths.values()) == {3}
    else:
        assert depths[gray] == 1
        assert sorted(depths.values()) == [1] + [3] * (IMAGES - 1)


FILTERS = {
    "only_classes": ["--only-classes", "dog,cat"],
    "limit_examples": ["--limit-examples", "2"],
    "class_examples": ["--class-examples", "2"],
    "override": ["-o", "year=2017", "-o", "use_supercategory=true"],
}


@pytest.mark.parametrize("option", sorted(FILTERS) + ["only_images"])
@pytest.mark.parametrize("fmt", ["coco", "pascal"])
def test_filters_equal_jax(fmt, option, tmp_path):
    args = FILTERS.get(option)
    if option == "only_images":  # COCO matches ids or file names
        args = ["--only-images",
                "1,train_0002.jpg" if fmt == "coco" else
                "train_0000,train_0002"]
    tree(tmp_path / "tree", fmt, seed=3)
    port_dir = assert_same_output(transform_both(
        tmp_path / "tree", tmp_path,
        ["--type", fmt, "--split", "train", *args]))
    count = len(records(port_dir / "train.tfrecords"))
    classes = json.loads((port_dir / "classes.json").read_text())
    if option == "only_classes":
        assert classes == ["cat", "dog"]
    elif option == "override" and fmt == "coco":
        assert classes == ["thing"]
    if option in ("limit_examples", "only_images"):
        assert count == 2
    elif option != "class_examples":
        assert count >= 2


def write_openimages_quota_tree(root):
    """Three local images: ``a`` with two boxes of A, ``b`` with one of
    A, ``c`` with one of B. At ``--class-examples 2`` A is full after
    ``a``, so a ``b`` that comes after ``a`` (only full classes) is
    dropped."""
    from PIL import Image

    images = root / "train" / "images"
    images.mkdir(parents=True)
    rng = np.random.default_rng(5)
    for name in "abc":
        Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
                        ).save(images / f"{name}.jpg", format="JPEG")
    rows = [("a", "/m/0"), ("a", "/m/0"), ("b", "/m/0"), ("c", "/m/1")]
    with open(root / "train" / "annotations-human-bbox.csv", "w") as f:
        f.write("ImageID,Source,LabelName,Confidence,XMin,XMax,YMin,YMax\n")
        for image_id, label in rows:
            f.write(f"{image_id},xclick,{label},1,0.125,0.5,0.25,0.75\n")
    (root / "class-descriptions.csv").write_text("/m/0,A\n/m/1,B\n")


@pytest.mark.parametrize("threads", [1, 25])
def test_openimages_class_quota_equals_jax(threads, tmp_path):
    """OpenImages' one reader-specific quota rule: a record whose labels
    are all at quota is dropped. With one fetch thread the order is fixed
    (a, b, c): both packages keep a and c, byte-equal. With 25 the order
    is the threads': each package keeps a and c, and b only when it came
    before a."""
    write_openimages_quota_tree(tmp_path / "tree")
    out = transform_both(tmp_path / "tree", tmp_path, [
        "--type", "openimages", "--split", "train", "--class-examples", "2",
        "-o", f"download_threads={threads}"])
    for result, directory in out.values():
        assert result.exit_code == 0, result.output
        order = list(read_back(directory))
        if threads == 1:
            assert order == ["a.jpg", "c.jpg"]
        elif "b.jpg" in order:
            assert sorted(order) == ["a.jpg", "b.jpg", "c.jpg"]
            assert order.index("b.jpg") < order.index("a.jpg")
        else:
            assert sorted(order) == ["a.jpg", "c.jpg"]
    if threads == 1:
        assert_same_output(out)


def test_two_splits_share_the_first_splits_classes(tmp_path):
    """``--split train --split val`` in one call, without per-class
    listings: val holds only dogs, and its labels index train's class
    list (its own scan would say ``["dog"]``)."""
    root = tmp_path / "tree"
    tree(root, "pascal", class_listings=False)
    val = write_annotation_tree(str(root), "pascal", 2, 9, ["dog"],
                                split="val", class_listings=False)
    port_dir = assert_same_output(
        transform_both(root, tmp_path, ["--type", "pascal", "--split",
                                        "train", "--split", "val"]),
        splits=("train", "val"))
    classes = json.loads((port_dir / "classes.json").read_text())
    assert classes == CLASSES
    back = read_back(port_dir, "val")
    for filename, (_, boxes) in back.items():
        np.testing.assert_array_equal(boxes, annotated(val, classes)[
            filename])
        assert set(boxes[:, 4]) == {CLASSES.index("dog")}


def test_pascal_listings_drop_unlisted_classes(tmp_path):
    """With per-class listings the listed names are the classes: boxes of
    a class without a listing are dropped."""
    root = tmp_path / "tree"
    written = tree(root, "pascal")
    os.remove(root / "ImageSets" / "Main" / "bird_train.txt")
    port_dir = assert_same_output(transform_both(
        root, tmp_path, ["--type", "pascal", "--split", "train"]))
    classes = json.loads((port_dir / "classes.json").read_text())
    assert classes == ["cat", "dog"]
    back = read_back(port_dir)
    for filename, boxes, names in written:
        keep = [i for i, n in enumerate(names) if n != "bird"]
        if keep:
            np.testing.assert_array_equal(
                back[filename][1][:, :4], boxes[keep])
        else:
            assert filename not in back


@pytest.mark.parametrize("args", [
    ["--type", "pascal", "--data-dir", "missing"],
    ["--type", "openimages", "--data-dir", "missing"],
    ["--type", "yolo", "--data-dir", "missing"],
], ids=["pascal-missing-dir", "openimages-missing-dir", "unknown-type"])
def test_errors_exit_as_jax(args, tmp_path):
    """A missing directory prints the error and exits 0; an unknown
    ``--type`` is refused by click's choice (exit 2), before any reader."""
    results = [CliRunner().invoke(group, [
        "transform", *args, "--output-dir", str(tmp_path / "out"),
        "--split", "train"]) for group in (jax_dataset, port_dataset)]
    jax_result, port_result = results
    assert port_result.exit_code == jax_result.exit_code
    assert echoed(port_result.output) == echoed(jax_result.output)
    assert port_result.exit_code == (2 if "yolo" in args else 0)
    assert not (tmp_path / "out" / "train.tfrecords").exists()


def test_unknown_reader_raises():
    with pytest.raises(ValueError, match="not a valid reader"):
        get_reader("yolo")


# ----------------------------------------------------- merge and the writer


def test_merge_equals_jax(tmp_path):
    """``merge`` of three formats' records: byte-equal files, equal
    output, the sum of the counts."""
    sources = []
    for fmt in ("csv", "flat", "taggerine"):
        tree(tmp_path / fmt, fmt, seed=len(sources))
        result = CliRunner().invoke(port_dataset, [
            "transform", "--type", fmt, "--data-dir", str(tmp_path / fmt),
            "--output-dir", str(tmp_path / f"{fmt}_out"), "--split",
            "train"])
        assert result.exit_code == 0, result.output
        sources.append(str(tmp_path / f"{fmt}_out" / "train.tfrecords"))
    results = {}
    for name, group in (("jax", jax_dataset), ("port", port_dataset)):
        results[name] = CliRunner().invoke(group, [
            "merge", *sources, str(tmp_path / f"{name}.tfrecords")])
        assert results[name].exit_code == 0, results[name].output
    assert [line.replace("port.", "jax.")
            for line in echoed(results["port"].output)] == echoed(
        results["jax"].output)
    merged = (tmp_path / "port.tfrecords").read_bytes()
    assert merged == (tmp_path / "jax.tfrecords").read_bytes()
    assert len(records(tmp_path / "port.tfrecords")) == 3 * IMAGES


GOOD = {"width": 64, "height": 48, "depth": 3, "filename": "x.jpg",
        "image_raw": b"\xff\xd8", "gt_boxes": [
            {"label": 0, "xmin": 1, "ymin": 2, "xmax": 30, "ymax": 20}]}
RECORDS = {
    "valid": GOOD,
    "no_width": {k: v for k, v in GOOD.items() if k != "width"},
    "no_boxes": {**GOOD, "gt_boxes": []},
    "box_without_label": {**GOOD, "gt_boxes": [
        {"xmin": 1, "ymin": 2, "xmax": 30, "ymax": 20}]},
    "bytes_filename": {**GOOD, "filename": b"y.jpg"},
}


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_validate_record_and_bytes_equal_jax(name):
    record = RECORDS[name]
    outcomes = []
    for module in (jw, pw):
        try:
            module.validate_record(record)
            outcomes.append(module.record_to_bytes(record))
        except Exception as e:
            outcomes.append((type(e).__name__, str(e)))
    assert outcomes[1] == outcomes[0]
    assert isinstance(outcomes[0], bytes) == (
        name in ("valid", "bytes_filename"))


def test_writer_skips_what_jax_skips(tmp_path):
    """A reader that yields every case of ``RECORDS``: both writers keep
    the same records, in the same bytes, and write ``classes.json``."""

    class Reader:
        classes = ["a", 2]

        def iterate(self):
            yield from (RECORDS[name] for name in sorted(RECORDS))

    counts = []
    for name, module in (("jax", jw), ("port", pw)):
        counts.append(module.ObjectDetectionWriter(
            Reader(), str(tmp_path / name), "train").save())
    assert counts == [2, 2]
    for name in ("train.tfrecords", "classes.json"):
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes()


# --------------------------------------------------------------- the slice


SLICE_CONFIG = {
    "train": {"batch_size": 2, "run_name": "slice", "seed": 3,
              "learning_rate": {"learning_rate": 1e-4}},
    "dataset": {"image_preprocessing": {
        "min_size": 48, "max_size": 64,
        "canvas_height": 48, "canvas_width": 64}},
    "model": {"type": "fasterrcnn", "network": {"num_classes": 3},
              "base_network": {"architecture": "resnet_v1_50"},
              "rpn": {"proposals": {"pre_nms_top_n": 64,
                                    "post_nms_top_n": 16}},
              "rcnn": {"proposals": {"total_max_detections": 10,
                                     "class_max_detections": 8}}},
}


@pytest.fixture(scope="module")
def sliced(tmp_path_factory):
    """Pascal annotations → the port's ``transform`` (train and val) → a
    config a user would write on the output; ``train.run`` for 2 steps."""
    import yaml

    root = tmp_path_factory.mktemp("slice")
    tree(root / "voc", "pascal")
    write_annotation_tree(str(root / "voc"), "pascal", 2, 4, CLASSES,
                          split="val", grayscale=(0,))
    result = CliRunner().invoke(cli, [
        "dataset", "transform", "--type", "pascal", "--data-dir",
        str(root / "voc"), "--output-dir", str(root / "records"),
        "--split", "train", "--split", "val"])
    assert result.exit_code == 0, result.output
    path = root / "config.yml"
    path.write_text(yaml.safe_dump({
        **SLICE_CONFIG,
        "train": {**SLICE_CONFIG["train"], "job_dir": str(root / "jobs")},
        "dataset": {**SLICE_CONFIG["dataset"],
                    "dir": str(root / "records")}}))
    journal = os.path.join(homedir.get_home(), "runs.json")
    before = (open(journal).read().splitlines()
              if os.path.exists(journal) else [])
    config = get_config(str(path))
    state = trainer.run(config, max_steps=2, device="cpu",
                        environment="local")
    with open(journal) as f:
        lines = f.read().splitlines()
    return {"root": root, "path": str(path), "state": state,
            "journal": [json.loads(line) for line in lines[len(before):]]}


def test_slice_trains_on_transformed_records(sliced):
    state = sliced["state"]
    assert state.step == 2 and len(state.history) == 2
    assert all(np.isfinite(h["total_loss"]) for h in state.history)
    assert os.path.exists(sliced["root"] / "jobs" / "slice" / "ckpt" /
                          "ckpt_step_2.pt")


def test_slice_evaluates_the_checkpoint(sliced):
    """``evaluate_once`` over the transformed ``val`` (2 images, one
    grayscale) from the step-2 checkpoint, loaded as ``lumi eval`` loads
    it: the trained weights, finite metrics, every image counted."""
    config = port_eval.apply_eval_config_mutations(
        get_config(sliced["path"]), "val")
    model = FasterRCNN(config)
    load_model_weights(model, load_checkpoint_variables(config))
    for name, value in sliced["state"].model.state_dict().items():
        assert np.array_equal(model.state_dict()[name].numpy(),
                              value.numpy()), name
    metrics = port_eval.evaluate_once(config, model)
    assert metrics["images"] == 2
    assert all(np.isfinite(v) for v in metrics.values())


def test_slice_journal_names_the_records(sliced, lumi_home_isolation):  # noqa: F811
    """``train.run`` appended one line to ``runs.json`` in the module's
    temporary home: the config (dataset dir = the transform's output),
    the environment and the versions of torch and the port."""
    import torch

    assert homedir.get_home() == lumi_home_isolation
    (line,) = sliced["journal"]
    assert line["config"]["dataset"]["dir"] == str(sliced["root"] /
                                                   "records")
    assert line["environment"] == "local"
    assert line["versions"] == {
        "torch": torch.__version__,
        "luminoth_tpu_torch": __version__}


def test_grayscale_record_reads_as_jax(sliced):
    """The datasets of both packages over the transformed ``val`` (its
    first image grayscale, depth 1 in the record): equal batches."""
    config, jax_config = (get_config(sliced["path"]),
                          jax_get_config([sliced["path"]]))
    config.dataset.split = jax_config.dataset.split = "val"
    kwargs = {"shuffle": False, "num_epochs": 1, "augment": False}
    got = list(ObjectDetectionDataset(config, **kwargs))
    want = list(JaxDataset(jax_config, **kwargs))
    assert len(got) == len(want) == 1
    for key, value in want[0].items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[0][key], value, key)
        else:
            assert got[0][key] == value, key
    image = got[0]["image"][0]
    assert np.array_equal(image[..., 0], image[..., 2])  # gray, as RGB


@pytest.mark.parametrize("environment", [None, "local", "cloud"])
def test_save_run_equals_jax(environment, sliced, tmp_path, monkeypatch):
    """Both packages' ``save_run`` on one config under one temporary
    home: two lines with the same keys, config, environment and diff;
    ``versions`` names each package's framework and itself."""
    monkeypatch.setenv("LUMI_HOME", str(tmp_path))
    jax_experiments.save_run(jax_get_config([sliced["path"]]),
                             environment=environment)
    experiments.save_run(get_config(sliced["path"]),
                         environment=environment)
    with open(tmp_path / "runs.json") as f:
        want, got = (json.loads(line) for line in f)
    assert sorted(got) == sorted(want)
    for key in ("user", "environment", "comment", "config",
                "extra_config"):
        assert got[key] == want[key], key
    assert (got["diff"] is None) == (want["diff"] is None) == (
        environment == "cloud")
    assert sorted(got["versions"]) == ["luminoth_tpu_torch", "torch"]
    assert sorted(want["versions"]) == ["jax", "luminoth_tpu"]
