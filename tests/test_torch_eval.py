"""The port's eval and checkpoint restore against the JAX package (CPU).

The small configuration of ``tests/test_torch_slice.py`` (Faster R-CNN
ResNet-50 v1, 3 classes, a 96 x 128 canvas, small proposal budgets), batch
2, on 5 synthetic 72 x 96 JPEG records of split ``val``, so the final batch
is padded. The weights are the JAX model's init with the classifiers
rescaled as in ``test_torch_slice.py``, saved by the JAX package's
``CheckpointManager`` as a full train state (parameters, batch statistics,
an adam optimizer state).

Checked here: ``calculate_metrics`` equals the JAX function exactly; the
port's msgpack reader equals ``flax.serialization.msgpack_restore``;
``evaluate_once`` equals the JAX one (images equal, AP/AR within 1e-6,
losses within 1e-5 relative); ``watch_checkpoints`` gives the same metrics
from a JAX msgpack checkpoint and a ``.pt`` one of the same weights; the
fallback subsampling draw does not depend on the device.
"""

import math
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import serialization

from luminoth_tpu import eval as jax_eval
from luminoth_tpu.models.fasterrcnn import FasterRCNN as JaxFasterRCNN
from luminoth_tpu.train import TrainState
from luminoth_tpu.utils import checkpoint_io as jax_checkpoint_io
from luminoth_tpu.utils.config import get_config as jax_get_config
from luminoth_tpu.utils.config import to_plain
from luminoth_tpu_torch import eval as port_eval
from luminoth_tpu_torch.formats import msgpack
from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN
from luminoth_tpu_torch.models.fasterrcnn import model as port_model
from luminoth_tpu_torch.utils import checkpoint_io
from luminoth_tpu_torch.utils.config import get_config
from luminoth_tpu_torch.utils.synthetic import write_synthetic_records
from luminoth_tpu_torch.utils.weights import load_flax_variables
from test_torch_slice import assert_detections_equal
from test_torch_isolation import few_threads, jax_cache_isolation  # noqa: F401
from test_torch_targets import jax_priorities

AP_ATOL = 1e-6
LOSS_RTOL = 1e-5
IMAGES = 5
BATCH = 2
STEP = 5  # the JAX checkpoint's step
CANVAS = (96, 128)

CONFIG = {
    "train": {"batch_size": BATCH, "run_name": "small"},
    "dataset": {"image_preprocessing": {
        "min_size": 96, "max_size": 128,
        "canvas_height": CANVAS[0], "canvas_width": CANVAS[1],
    }},
    "model": {
        "type": "fasterrcnn",
        "network": {"num_classes": 3},
        "base_network": {"architecture": "resnet_v1_50"},
        "rpn": {
            "proposals": {"pre_nms_top_n": 128, "post_nms_top_n": 32},
        },
        "rcnn": {
            "proposals": {
                "total_max_detections": 10, "class_max_detections": 8,
                "min_prob_threshold": 0.0,
            },
        },
    },
}


def write_config(path, data_dir, job_dir):
    config = {**CONFIG,
              "train": {**CONFIG["train"], "job_dir": str(job_dir)},
              "dataset": {**CONFIG["dataset"], "dir": str(data_dir)}}
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return str(path)


def rescaled_jax_variables(config):
    """JAX random init, with the heads rescaled to unsaturated logits (the
    procedure of ``tests/test_torch_slice.py``)."""
    init = JaxFasterRCNN(to_plain(config)).init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + CANVAS + (3,)))
    variables = jax.tree_util.tree_map(np.array, init)
    params = variables["params"]
    images = torch.from_numpy(
        (np.random.RandomState(0).rand(2, *CANVAS, 3) * 255)
        .astype(np.float32))

    def port_forward():
        port = load_flax_variables(FasterRCNN(config), variables).eval()
        with torch.inference_mode():
            return port(images)

    rpn = port_forward()["rpn_prediction"]
    params["rpn"]["cls_conv"]["kernel"] *= 3.0 / float(
        rpn["rpn_cls_score"].std())
    rcnn = port_forward()["classification_prediction"]["rcnn"]
    params["rcnn"]["fc_classifier"]["kernel"] *= 3.0 / float(
        rcnn["cls_score"].std())
    params["rcnn"]["fc_bbox"]["kernel"] *= 0.5 / float(
        rcnn["bbox_offsets"].std())
    return variables


def jax_train_state(variables):
    """A full JAX train state: parameters, batch statistics and an adam
    optimizer state (nested tuples, int32 counts)."""
    params = variables["params"]
    return TrainState(step=jnp.asarray(STEP, jnp.int32), params=params,
                      opt_state=optax.adam(1e-3).init(params),
                      batch_stats=variables["batch_stats"])


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """Config files of both packages, data, weights and a JAX checkpoint
    under ``job_dir/small/ckpt``."""
    root = tmp_path_factory.mktemp("eval")
    data_dir, boxes = write_synthetic_records(
        str(root / "data"), IMAGES, 3, seed=7, height=72, width=96,
        split="val")
    job_dir = root / "jobs"
    path = write_config(root / "config.yml", data_dir, job_dir)
    config = get_config(path)
    variables = rescaled_jax_variables(config)
    ckpt_dir = job_dir / "small" / "ckpt"
    jax_checkpoint_io.CheckpointManager(str(ckpt_dir)).save(
        jax_train_state(variables), STEP)
    return {"path": path, "root": root, "job_dir": job_dir,
            "ckpt": ckpt_dir / f"ckpt_step_{STEP}.msgpack",
            "variables": variables, "boxes": boxes}


def eval_configs(path):
    """``(port config, JAX config)`` of ``path`` with the eval mutations."""
    port = port_eval.apply_eval_config_mutations(get_config(path), "val")
    jax_config = jax_eval.apply_eval_config_mutations(
        jax_get_config([path]), "val")
    return port, jax_config


def keyed_forward(model, image, gt_boxes, im_shape):
    """The port's eval forward with the JAX model's fallback subsampling
    draws, ``fold_in(PRNGKey(0), stage)`` split per image."""
    batch, height, width = image.shape[:3]
    stride = int(model.cfg.model.anchors.stride)
    sizes = {
        "rpn": (model.anchor_reference.shape[0] * math.ceil(height / stride)
                * math.ceil(width / stride)),
        "rcnn": int(model.cfg.model.rpn.proposals.post_nms_top_n),
    }
    priorities = {
        stage: jax_priorities(jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(0), index), batch),
            sizes[stage])
        for index, stage in enumerate(("rpn", "rcnn"))
    }
    preds = model(image.float(), gt_boxes=gt_boxes, im_shape=im_shape,
                  priorities=priorities)
    cp = preds["classification_prediction"]
    losses = model.loss(preds, return_all=True)
    return cp["objects"], cp["labels"], cp["probs"], cp["valid"], losses


def assert_metrics_equal(got, want):
    assert got["images"] == want["images"]
    for key in ("AP@0.5", "AP@0.75", "AP@[0.5:0.95]", "AR@[0.5:0.95]"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=AP_ATOL, err_msg=key)
    losses = sorted(k for k in want if k.startswith("losses/"))
    assert sorted(k for k in got if k.startswith("losses/")) == losses
    for key in losses:
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                   atol=0, err_msg=key)


# ----------------------------------------------------------- the metrics


def detection_sets(case):
    """Seeded detections and ground truth per image for ``case``."""
    rng = np.random.RandomState(zlib.crc32(case.encode()))
    out = {k: [] for k in
           ("bboxes", "classes", "scores", "gt_bboxes", "gt_classes")}
    if case == "zero_batches":
        return out, 3
    images = 6
    for i in range(images):
        n_gt = rng.randint(0, 5)
        xy = rng.uniform(0, 200, (n_gt, 2))
        gt = np.concatenate([xy, xy + rng.uniform(10, 80, (n_gt, 2))], 1)
        gt_classes = rng.randint(0, 3, n_gt)
        if case == "empty_class":
            gt_classes = np.minimum(gt_classes, 1)  # class 2 has no gt
        # Jittered copies of the ground truth, duplicates and strays.
        dets = gt + rng.normal(0, 6, gt.shape)
        classes = gt_classes.copy()
        if case == "duplicates" and n_gt:
            dets = np.concatenate([dets, dets + rng.normal(0, 2, dets.shape)])
            classes = np.concatenate([classes, classes])
        n_stray = rng.randint(0, 4)
        xy = rng.uniform(0, 200, (n_stray, 2))
        dets = np.concatenate(
            [dets, np.concatenate([xy, xy + rng.uniform(10, 80, (n_stray, 2))],
                                  1)])
        classes = np.concatenate([classes, rng.randint(0, 3, n_stray)])
        scores = rng.uniform(0, 1, len(dets))
        if case == "tied_scores":
            scores = np.round(scores, 1)
        out["bboxes"].append(dets.astype(np.float32))
        out["classes"].append(classes.astype(np.int64))
        out["scores"].append(scores.astype(np.float32))
        out["gt_bboxes"].append(gt.astype(np.float32))
        out["gt_classes"].append(gt_classes.astype(np.int64))
    return out, 3


@pytest.mark.parametrize("case", ["random", "empty_class", "duplicates",
                                  "tied_scores", "zero_batches"])
def test_calculate_metrics_equals_jax(case):
    output, num_classes = detection_sets(case)
    got = port_eval.calculate_metrics(output, num_classes)
    want = jax_eval.calculate_metrics(output, num_classes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if case != "zero_batches":
        assert got[0].max() > 0  # some detection matched


# ------------------------------------------------------ the msgpack reader


def assert_tree_equal(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for key in want:
            assert_tree_equal(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) and (
        want.dtype.name == "bfloat16"
    ):
        assert torch.is_tensor(got) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(want), path
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(),
            np.asarray(want).view(np.int16), err_msg=path)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and (
            got == want or (got != got and want != want)), path


class TestMsgpack:
    def test_full_train_state_equals_flax(self, small):
        data = small["ckpt"].read_bytes()
        want = serialization.msgpack_restore(data)
        got = msgpack.restore(data)
        assert_tree_equal(got, want)
        # The optimizer state is there: adam's counts and moments.
        assert set(got) == {"step", "params", "opt_state", "batch_stats"}
        assert got["opt_state"]["0"]["count"].dtype == np.int32

    @pytest.mark.parametrize("tree", [
        {"bf16": jnp.arange(7, dtype=jnp.bfloat16) / 3,
         "bf16_2d": jnp.ones((2, 3), jnp.bfloat16) * -1.5},
        {"f32": np.float32(1.5), "i64": np.int64(-2 ** 40),
         "u8": np.uint8(200), "bool": np.bool_(True),
         "bf16": jnp.bfloat16(2.5)},
        {"c": 1.5 - 2.25j, "arr": np.asarray([1 + 2j, 3j], np.complex64)},
        {1: np.ones(2, np.float16), "a": {2: 3, 30: "x"}},
        {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                  2 ** 64 - 1, -1, -32, -33, -128, -129, -2 ** 15 - 1,
                  -2 ** 31 - 1, -2 ** 63],
         "floats": (0.5, -1e300, float("inf")), "none": None,
         "flags": (True, False), "s": "é" * 40, "long": "x" * 70000,
         "b": b"\x00\xff" * 200, "empty": {}, "t": ()},
        {"big": {str(i): i for i in range(70000)},
         "arr": np.full((2,), 3, np.int16)},
    ], ids=["bfloat16", "npscalar", "complex", "int_keys", "scalars",
            "map32"])
    def test_leaves_equal_flax(self, tree):
        data = serialization.to_bytes(tree)
        assert_tree_equal(msgpack.restore(data),
                          serialization.msgpack_restore(data))

    @pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
    def test_chunked_arrays_equal_flax(self, monkeypatch, dtype):
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
        tree = {"w": (np.arange(300).reshape(3, 100) / 7).astype(dtype),
                "small": np.ones(3, np.float32)}
        data = serialization.to_bytes(tree)
        assert b"__msgpack_chunked_array__" in data
        got = msgpack.restore(data)
        assert_tree_equal(got, serialization.msgpack_restore(data))
        assert tuple(got["w"].shape) == (3, 100)

    def test_rejects_truncated_and_trailing_bytes(self):
        data = serialization.to_bytes({"a": np.ones(4)})
        with pytest.raises(msgpack.MsgpackError):
            msgpack.restore(data[:-3])
        with pytest.raises(msgpack.MsgpackError):
            msgpack.restore(data + b"\x00")


# ------------------------------------------------------- checkpoint files


class TestCheckpointFiles:
    def test_latest_state_dict_reads_both_formats(self, small, tmp_path):
        manager = checkpoint_io.CheckpointManager(str(tmp_path))
        (tmp_path / f"ckpt_step_{STEP}.msgpack").write_bytes(
            small["ckpt"].read_bytes())
        state, step = manager.latest_state_dict()
        assert step == STEP and "opt_state" in state
        # A .pt of the same step is preferred; a newer msgpack wins.
        manager.save({"step": STEP, "model": {}}, STEP)
        state, step = manager.latest_state_dict()
        assert step == STEP and "model" in state
        (tmp_path / "ckpt_step_9.msgpack").write_bytes(
            small["ckpt"].read_bytes())
        assert manager.latest_state_dict()[1] == 9
        assert manager.evaluable_steps() == [(STEP, "pt"), (9, "msgpack")]
        # Resume still sees only the port's own files.
        assert manager.all_steps() == [STEP]

    def test_unreadable_newest_falls_back(self, small, tmp_path):
        manager = checkpoint_io.CheckpointManager(str(tmp_path))
        (tmp_path / "ckpt_step_3.msgpack").write_bytes(
            small["ckpt"].read_bytes())
        (tmp_path / "ckpt_step_4.msgpack").write_bytes(
            small["ckpt"].read_bytes()[:1000])
        (tmp_path / "ckpt_step_4.pt").write_bytes(b"not a checkpoint")
        assert manager.latest_state_dict()[1] == 3
        (tmp_path / "ckpt_step_3.msgpack").write_bytes(b"\xc1")
        assert manager.latest_state_dict() == (None, None)

    def test_load_model_weights_from_both_formats(self, small):
        config = get_config(small["path"])
        want = load_flax_variables(FasterRCNN(config), small["variables"])
        from_msgpack = checkpoint_io.load_model_weights(
            FasterRCNN(config), msgpack.load(small["ckpt"]))
        from_pt = checkpoint_io.load_model_weights(
            FasterRCNN(config), {"model": want.state_dict()})
        for model in (from_msgpack, from_pt):
            for key, value in want.state_dict().items():
                assert torch.equal(model.state_dict()[key], value), key


# --------------------------------------------------------------- the eval


class TestEvaluate:
    def test_evaluate_once_equals_jax(self, small):
        config, jax_config = eval_configs(small["path"])
        assert config.model.rcnn.proposals.pre_nms_max_candidates == 0
        variables = small["variables"]
        # Both forwards record their detections: at random weights no
        # detection reaches IoU 0.5 (AP and AR are 0 on both sides), so
        # the detections themselves are held equal too.
        jax_forward = jax_eval._build_forward(
            JaxFasterRCNN(to_plain(jax_config)))
        jax_outs, port_outs = [], []

        def jax_recording(*args):
            outs = jax_forward(*args)
            jax_outs.append([np.asarray(t) for t in outs[:4]])
            return outs

        def port_recording(*args):
            outs = keyed_forward(*args)
            port_outs.append([t.numpy() for t in outs[:4]])
            return outs

        want = jax_eval.evaluate_once(jax_config, None, variables,
                                      forward=jax_recording)
        model = load_flax_variables(FasterRCNN(config), variables)
        got = port_eval.evaluate_once(config, model, forward=port_recording)
        assert got["images"] == IMAGES  # the padded row counted once
        assert_metrics_equal(got, want)
        assert len(port_outs) == len(jax_outs) == 3
        for (objects, labels, probs, valid), want_outs in zip(port_outs,
                                                              jax_outs):
            assert_detections_equal(
                {"objects": objects, "labels": labels, "probs": probs,
                 "valid": valid},
                dict(zip(("objects", "labels", "probs", "valid"),
                         want_outs)))
            assert valid.sum() > 0

    def test_padded_rows_count_once(self, small):
        """5 images at batch 2: a forward that returns the ground truth
        scores every real image once (AP 1 on each class that has ground
        truth) and weights the losses by the real image count."""
        config, _ = eval_configs(small["path"])
        batches = []

        def gt_forward(model, image, gt_boxes, im_shape):
            batches.append(image.shape[0])
            valid = gt_boxes[..., 4] >= 0
            return (gt_boxes[..., :4], gt_boxes[..., 4].long(),
                    valid.float(), valid,
                    {"total_loss": torch.tensor(float(len(batches)))})

        metrics = port_eval.evaluate_once(config, None, forward=gt_forward)
        assert batches == [BATCH] * 3
        assert metrics["images"] == IMAGES
        present = {int(c) for b in small["boxes"] for c in b[:, 4]}
        assert metrics["AP@[0.5:0.95]"] == pytest.approx(
            len(present) / 3, abs=1e-12)
        assert metrics["losses/total_loss"] == pytest.approx(
            (2 * 1 + 2 * 2 + 1 * 3) / IMAGES)

    def test_watch_checkpoints_both_formats(self, small, tmp_path):
        """A JAX msgpack checkpoint and a .pt one of the same weights give
        the same metrics; an unreadable older file is skipped."""
        config, _ = eval_configs(small["path"])
        ckpt = tmp_path / "run" / "ckpt"
        ckpt.mkdir(parents=True)
        (ckpt / "ckpt_step_2.msgpack").write_bytes(b"\x00truncated")
        (ckpt / f"ckpt_step_{STEP}.msgpack").write_bytes(
            small["ckpt"].read_bytes())

        class Writer:
            def __init__(self):
                self.scalars = {}

            def add_scalar(self, name, value, step):
                self.scalars.setdefault(step, {})[name] = value

            def flush(self):
                pass

        writer = Writer()
        model = FasterRCNN(config)
        port_eval.watch_checkpoints(config, model, str(tmp_path / "run"),
                                    watch=False, writer=writer,
                                    forward=keyed_forward)
        assert sorted(writer.scalars) == [STEP]
        assert port_eval.get_checkpoints(str(tmp_path / "run")) == [2, STEP]

        state = {"step": STEP + 1, "model": model.state_dict()}
        checkpoint_io.CheckpointManager(str(ckpt)).save(state, STEP + 1)
        port_eval.watch_checkpoints(config, FasterRCNN(config),
                                    str(tmp_path / "run"), watch=False,
                                    from_global_step=STEP, writer=writer,
                                    forward=keyed_forward)
        assert sorted(writer.scalars) == [STEP, STEP + 1]
        first, second = writer.scalars[STEP], writer.scalars[STEP + 1]
        for name in first:
            if name not in ("validation/images_per_second",):
                assert first[name] == second[name], name


class TestFallbackDraw:
    @pytest.mark.parametrize("device", ["cpu", "meta"])
    def test_draw_is_on_the_cpu_whatever_the_device(self, monkeypatch,
                                                    device):
        """Without a generator, each stage's priorities come from a CPU
        generator seeded with the stage index, then move to the device: the
        same values on every device."""
        drawn = []
        draw = port_model.draw_priorities

        def recording(shape, generator, on):
            drawn.append((generator.device, on))
            return draw(shape, generator, on)

        monkeypatch.setattr(port_model, "draw_priorities", recording)
        model = FasterRCNN.__new__(FasterRCNN)
        for index, stage in enumerate(("rpn", "rcnn")):
            got = FasterRCNN._priorities(model, stage, (2, 5), None, None,
                                         torch.device(device))
            assert all(p.device.type == device for p in got)
            if device == "cpu":
                generator = torch.Generator()
                generator.manual_seed(index)
                want = [torch.rand((2, 5), generator=generator)
                        for _ in range(2)]
                for g, w in zip(got, want):
                    assert torch.equal(g, w)
        assert drawn == [(torch.device("cpu"), "cpu")] * 2

    def test_generator_draws_are_unchanged(self):
        """Training passes a generator: it draws on the generator's own
        device, as before."""
        model = FasterRCNN.__new__(FasterRCNN)
        generator = torch.Generator()
        generator.manual_seed(11)
        got = FasterRCNN._priorities(model, "rpn", (2, 5), generator, None,
                                     torch.device("cpu"))
        generator.manual_seed(11)
        for g in got:
            assert torch.equal(g, torch.rand((2, 5), generator=generator))


def test_eval_command_on_the_cpu(small, tmp_path):
    """``eval --device cpu --no-watch`` evaluates the JAX checkpoint and
    writes its scalars."""
    from click.testing import CliRunner

    result = CliRunner().invoke(port_eval.eval, [
        "-c", small["path"], "--no-watch", "--device", "cpu",
        "--files-per-class", "0"])
    assert result.exit_code == 0, result.output
    assert os.path.isdir(os.path.join(str(small["job_dir"]), "small", "val"))
