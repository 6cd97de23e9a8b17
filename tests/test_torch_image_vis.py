"""The port's training and evaluation visualisation against the JAX package
(CPU).

* Every entry of every registry list (``summaries_fn``: both model types,
  the three modes) pixel-equal to the JAX function on equal inputs (the
  synthetic prediction dicts of ``tests/test_image_vis.py``), and on an
  empty dict.
* A monitor forward of a small Faster R-CNN (ResNet-50 v1, 2 x 96 x 128)
  and of SSD (1 x 300 x 300), random weights from a seed, in both
  packages, through each package's ``ImageVisHook`` in every mode: the
  port writes the same summary names as JAX, so none is dropped by
  ``image_vis_summaries``' ``except``.
* ``var_vis``: the tags and values of JAX ``VarVisHook`` (``full`` level)
  for the same weights; the timer's cadence.
* Eval's ``files_per_class`` images equal to JAX ``evaluate_once``'s on
  equal detections.
* ``formats/tfevents.py``: its event files read back through TensorFlow's
  ``summary_iterator`` with the tags, steps, values and image pixels that
  tensorboardX writes for the same calls; its ``read_events`` reads them
  as TensorFlow does.
"""

import glob
import io
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luminoth_tpu import eval as jax_eval
from luminoth_tpu.models.fasterrcnn import FasterRCNN as JaxFasterRCNN
from luminoth_tpu.models.ssd import SSD as JaxSSD
from luminoth_tpu.utils import image_vis as jax_image_vis
from luminoth_tpu.utils.config import to_plain
from luminoth_tpu.utils.hooks import ImageVisHook as JaxImageVisHook
from luminoth_tpu.utils.hooks import SecondOrStepTimer as JaxTimer
from luminoth_tpu.utils.hooks import VarVisHook as JaxVarVisHook
from luminoth_tpu_torch import eval as port_eval
from luminoth_tpu_torch import train as trainer
from luminoth_tpu_torch.formats.tfevents import SummaryWriter, read_events
from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN
from luminoth_tpu_torch.models.ssd import SSD
from luminoth_tpu_torch.utils import image_vis
from luminoth_tpu_torch.utils.hooks import (
    ImageVisHook,
    SecondOrStepTimer,
    VarVisHook,
)
from luminoth_tpu_torch.utils import config as torch_config
from luminoth_tpu_torch.utils.synthetic import write_synthetic_records
from luminoth_tpu_torch.utils.weights import (
    flatten_variables,
    init_variables,
    load_flax_variables,
    nest_variables,
)
from test_image_vis import (  # noqa: F401  (fixtures)
    all_anchors,
    frcnn_pred,
    gt_boxes,
    image,
    ssd_pred,
)
from test_torch_eval import BATCH, IMAGES, eval_configs, write_config
from test_torch_isolation import few_threads, jax_cache_isolation  # noqa: F401
from test_torch_ssd import GT as SSD_GT
from test_torch_ssd import small_config as ssd_config
from test_torch_train import OVERRIDES, train_batch

MODES = ("train", "eval", "debug")
ENTRIES = [(model, mode, index)
           for model in ("fasterrcnn", "ssd") for mode in MODES
           for index in range(len(jax_image_vis.summaries_fn[model][mode]))]


class Recorder:
    """A summary writer that keeps what it is given."""

    def __init__(self):
        self.images, self.scalars, self.histograms = {}, {}, {}

    def add_image(self, tag, img, step, dataformats="HWC"):
        assert dataformats == "HWC"
        self.images[tag, step] = np.asarray(img)

    def add_scalar(self, tag, value, step):
        self.scalars[tag, step] = value

    def add_histogram(self, tag, values, step):
        self.histograms[tag, step] = np.asarray(values)

    def flush(self):
        pass


# ------------------------------------------------------- the registry


def test_the_registries_are_the_same():
    for model in ("fasterrcnn", "ssd"):
        assert set(image_vis.summaries_fn[model]) == set(MODES)
        for mode in MODES:
            assert [f.__name__ for f in image_vis.summaries_fn[model][mode]] \
                == [f.__name__ for f in
                    jax_image_vis.summaries_fn[model][mode]]


@pytest.mark.parametrize("model,mode,index", ENTRIES,
                         ids=[f"{m}-{d}-{i}" for m, d, i in ENTRIES])
def test_draw_function_is_pixel_equal(model, mode, index, image, frcnn_pred,
                                      ssd_pred, gt_boxes, all_anchors):
    port = image_vis.summaries_fn[model][mode][index]
    want = jax_image_vis.summaries_fn[model][mode][index]
    assert port.__name__ == want.__name__
    pred = frcnn_pred if model == "fasterrcnn" else ssd_pred
    for kwargs in (
        {"prediction_dict": pred, "gt_boxes": gt_boxes,
         "all_anchors": all_anchors, "variances": None},
        {"prediction_dict": pred, "gt_boxes": gt_boxes,
         "all_anchors": all_anchors, "variances": (0.2, 0.3)},
        {"prediction_dict": {}, "gt_boxes": None, "all_anchors": None},
    ):
        got, expected = port(image, **kwargs), want(image, **kwargs)
        assert got.dtype == expected.dtype == np.uint8
        np.testing.assert_array_equal(got, expected)


def test_the_frcnn_debug_dispatch_equals_jax(image, frcnn_pred, gt_boxes,
                                             all_anchors):
    kwargs = dict(config={"type": "fasterrcnn"}, image_vis_mode="debug",
                  image=image, gt_boxes=gt_boxes, all_anchors=all_anchors,
                  extra_tag="x")
    got = image_vis.image_vis_summaries(frcnn_pred, **kwargs)
    want = jax_image_vis.image_vis_summaries(frcnn_pred, **kwargs)
    assert list(got) == list(want)
    assert len(got) == len(jax_image_vis.summaries_fn["fasterrcnn"]["debug"])
    for name in got:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# ------------------------------------------------- the monitor forward


def monitor_forwards(jax_model, port_model, variables, batch):
    """Both packages' monitor forward of ``batch`` on the same
    ``variables``: JAX's ``model.apply(train=False)`` (jitted, as the JAX
    ``train.run`` runs it), the port's ``train.monitor_forward``."""
    jax_variables = nest_variables(flatten_variables(variables))
    want = jax.jit(lambda v, images, gt: jax_model.apply(
        v, images, gt_boxes=gt, train=False))(
            jax_variables, jnp.asarray(batch["image"]),
            jnp.asarray(batch["gt_boxes"]))
    model = load_flax_variables(port_model, variables)
    got = trainer.monitor_forward(model, {
        "image": torch.from_numpy(batch["image"]),
        "gt_boxes": torch.from_numpy(batch["gt_boxes"])})
    return got, want


@pytest.fixture(scope="module")
def frcnn_monitor():
    from luminoth_tpu.utils.config import Config

    config = torch_config.get_model_config(
        torch_config.get_base_config("fasterrcnn"), Config(OVERRIDES))
    batch = train_batch()
    got, want = monitor_forwards(JaxFasterRCNN(config), FasterRCNN(config),
                                 init_variables(config, seed=0), batch)
    variances = tuple(config.model.rcnn.target_normalization_variances)
    return batch, got, want, variances


@pytest.fixture(scope="module")
def ssd_monitor():
    config = ssd_config()
    images = (np.random.RandomState(0).rand(1, 300, 300, 3) * 255).astype(
        np.float32)
    batch = {"image": images, "gt_boxes": SSD_GT[:1]}
    got, want = monitor_forwards(JaxSSD(to_plain(config)), SSD(config),
                                 init_variables(config, seed=0), batch)
    return batch, got, want, tuple(config.model.variances)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", ["fasterrcnn", "ssd"])
def test_monitor_forward_yields_the_names_of_jax(family, mode, frcnn_monitor,
                                                 ssd_monitor):
    batch, got, want, variances = (frcnn_monitor if family == "fasterrcnn"
                                   else ssd_monitor)
    writers = Recorder(), Recorder()
    ImageVisHook(writers[0], family, image_vis_mode=mode, every_steps=1,
                 variances=variances).after_step(1, batch, got)
    JaxImageVisHook(writers[1], family, image_vis_mode=mode, every_steps=1,
                    variances=variances).after_step(1, batch, want)
    names = [sorted(tag for tag, _ in w.images) for w in writers]
    assert names[0] == names[1]
    registry = jax_image_vis.summaries_fn[family][mode]
    if len(names[1]) == len(registry):
        assert len(names[0]) == len(registry)
    assert names[0]  # draw_gt_boxes at least
    for tag in names[0]:
        assert writers[0].images[tag, 1].shape == \
            writers[1].images[tag, 1].shape


# --------------------------------------------------- var_vis and timer


def test_var_vis_equals_jax():
    from luminoth_tpu.utils.config import Config

    config = torch_config.get_model_config(
        torch_config.get_base_config("fasterrcnn"), Config(OVERRIDES))
    variables = init_variables(config, seed=4)
    model = load_flax_variables(FasterRCNN(config), variables)
    writers = Recorder(), Recorder()
    VarVisHook(writers[0], mode="full", every_steps=1).after_step(3, model)
    JaxVarVisHook(writers[1], mode="full", every_steps=1).after_step(
        3, jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    assert writers[0].scalars.keys() == writers[1].scalars.keys()
    assert len(writers[0].scalars) > 5 * 100
    for key, value in writers[1].scalars.items():
        assert writers[0].scalars[key] == value, key
    assert writers[0].histograms.keys() == writers[1].histograms.keys()
    for key, value in writers[1].histograms.items():
        np.testing.assert_array_equal(writers[0].histograms[key], value)


def test_the_timer_cadence_equals_jax(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    for kwargs in ({"every_steps": 3}, {"every_secs": 10},
                   {"every_steps": 4, "every_secs": 25}, {}):
        timers = SecondOrStepTimer(**kwargs), JaxTimer(**kwargs)
        fired = [[], []]
        for step in range(1, 30):
            now[0] += 4.0
            for timer, out in zip(timers, fired):
                if timer.should_trigger(step):
                    timer.update(step)
                    out.append(step)
        assert fired[0] == fired[1], kwargs
        if kwargs:
            assert fired[0]


# ------------------------------------------------------ files_per_class


def test_eval_files_per_class_equals_jax(tmp_path):
    data_dir, _ = write_synthetic_records(
        str(tmp_path / "data"), IMAGES, 3, seed=7, height=72, width=96,
        split="val")
    config, jax_config = eval_configs(
        write_config(tmp_path / "config.yml", data_dir, tmp_path / "jobs"))

    def detections(gt_boxes):
        gt = np.asarray(gt_boxes)
        valid = gt[..., 4] >= 0
        probs = np.where(valid, 0.9, 0.0).astype(np.float32)
        probs[..., 0] = 0.4  # below draw_object_predictions' 0.5
        return gt[..., :4], gt[..., 4].astype(np.int32), probs, valid

    def jax_forward(variables, image, gt_boxes, im_shape):
        objects, labels, probs, valid = detections(gt_boxes)
        return (jnp.asarray(objects), jnp.asarray(labels),
                jnp.asarray(probs), jnp.asarray(valid),
                {"total_loss": jnp.float32(0.0)})

    def port_forward(model, image, gt_boxes, im_shape):
        objects, labels, probs, valid = detections(gt_boxes.numpy())
        return (torch.from_numpy(objects), torch.from_numpy(labels),
                torch.from_numpy(probs), torch.from_numpy(valid),
                {"total_loss": torch.tensor(0.0)})

    writers = Recorder(), Recorder()
    port_eval.evaluate_once(config, None, writer=writers[0], global_step=4,
                            forward=port_forward, files_per_class=1)
    jax_eval.evaluate_once(jax_config, None, None, writer=writers[1],
                           global_step=4, forward=jax_forward,
                           files_per_class=1)
    assert writers[0].images.keys() == writers[1].images.keys()
    tags = [tag for tag, _ in writers[0].images]
    assert 1 <= len(tags) <= 3 and all(tag.endswith("/1") for tag in tags)
    for key, value in writers[1].images.items():
        np.testing.assert_array_equal(writers[0].images[key], value)
    assert BATCH < IMAGES


# --------------------------------------------------------- event files


def _read_events(directory):
    import tensorflow as tf
    from PIL import Image

    out = []
    for path in sorted(glob.glob(str(directory / "events*"))):
        for event in tf.compat.v1.train.summary_iterator(path):
            for value in event.summary.value:
                kind = value.WhichOneof("value")
                if kind == "image":
                    payload = (np.asarray(Image.open(io.BytesIO(
                        value.image.encoded_image_string))).tolist(),
                        value.image.height, value.image.width,
                        value.image.colorspace)
                elif kind == "histo":
                    payload = str(value.histo)
                else:
                    payload = value.simple_value
                out.append((event.step, value.tag, kind, payload))
    return out


def test_event_files_read_back_as_tensorboardx_writes_them(tmp_path):
    import tensorboardX

    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (20, 30, 3), dtype=np.uint8)
    values = rng.standard_normal(1000).astype(np.float32)
    for name, writer_class in (("port", SummaryWriter),
                               ("tbx", tensorboardX.SummaryWriter)):
        writer = writer_class(str(tmp_path / name))
        writer.add_scalar("losses/total_loss", np.float32(1.2345), 3)
        writer.add_scalar("bad tag:x", 7, 4)
        writer.add_image("image_vis/draw_gt_boxes", img, 4,
                         dataformats="HWC")
        writer.add_histogram("variables/rpn/conv/kernel", values, 5)
        writer.add_histogram("variables/zeros", np.zeros(7), 6)
        writer.flush()
        writer.close()
    got, want = _read_events(tmp_path / "port"), _read_events(tmp_path / "tbx")
    assert len(got) == 5
    assert got == want
    # The port's own reader reads what TensorFlow reads.
    from PIL import Image

    (path,) = glob.glob(str(tmp_path / "port" / "events*"))
    mine = read_events(path)
    assert [(s, t, k) for s, t, k, _ in mine] == [
        (s, t, k) for s, t, k, _ in got]
    assert [v for _, _, k, v in mine if k == "simple_value"] == [
        v for _, _, k, v in got if k == "simple_value"]
    (png,) = [v for _, _, k, v in mine if k == "image"]
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                  img)
