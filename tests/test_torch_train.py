"""The port's training slice end to end against the JAX package (CPU).

Two train steps of ``luminoth_tpu_torch.train.make_train_step`` against the
JAX ``make_train_step``, on Faster R-CNN ResNet-50 v1, 3 classes, a 2 x 96 x
128 canvas and the small proposal budgets of ``tests/test_torch_slice.py``,
with the base config's training defaults (``fine_tune_from: block2``,
frozen batch-norm statistics, weight decay 5e-4), the clip at 10 and
momentum 0.9. The same weights (the JAX init, classifiers rescaled as in
``test_torch_slice.py``) and the same batch go through both. The JAX model
draws its subsampling keys through ``make_rng``; a subclass here returns
fixed keys per stage instead, and the port gets the uniforms those keys
give.

Targets must be equal, the losses and the gradient norm agree to 1e-5
relative, the parameters after each step to atol 1e-6 + rtol 1e-5. Then
``run()`` trains on synthetic TFRecords, checkpoints and resumes.
"""

import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from luminoth_tpu.models.fasterrcnn import FasterRCNN as JaxFasterRCNN
from luminoth_tpu.train import TrainState, make_train_step as jax_step
from luminoth_tpu.utils import training as jax_training
from luminoth_tpu.utils.config import Config
from luminoth_tpu_torch import train as trainer
from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN
from luminoth_tpu_torch.utils import config as torch_config
from luminoth_tpu_torch.utils import training
from luminoth_tpu_torch.utils.weights import (
    load_flax_variables,
    torch_state_from_flax,
)

LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_SEEDS = (100, 101)  # fixed JAX target keys: RPN, RCNN

OVERRIDES = {
    "train": {"clip_by_norm": True, "learning_rate": {"learning_rate": 1e-3},
              "optimizer": {"type": "momentum", "momentum": 0.9}},
    "model": {
        "network": {"num_classes": 3},
        "base_network": {"architecture": "resnet_v1_50"},
        "rpn": {"proposals": {"pre_nms_top_n": 128, "post_nms_top_n": 32},
                "target": {"minibatch_size": 64}},
        "rcnn": {"target": {"minibatch_size": 16}},
    },
}


class KeyedFasterRCNN(JaxFasterRCNN):
    """The JAX model with fixed subsampling keys per stage."""

    def _target_keys(self, batch, stage):
        return jax.random.split(jax.random.PRNGKey(STAGE_SEEDS[stage]), batch)


def port_priorities(batch, anchors, proposals):
    """The uniforms the fixed JAX keys give, per stage, for the port."""
    out = {}
    for stage, n in (("rpn", anchors), ("rcnn", proposals)):
        keys = jax.random.split(jax.random.PRNGKey(STAGE_SEEDS[stage == "rcnn"]),
                                batch)
        draws = [jax.random.split(key) for key in keys]
        out[stage] = tuple(
            torch.from_numpy(np.stack([
                np.asarray(jax.random.uniform(pair[i], (n,))) for pair in draws
            ]))
            for i in range(2)
        )
    return out


@pytest.fixture(scope="module")
def config():
    return torch_config.get_model_config(
        torch_config.get_base_config("fasterrcnn"), Config(OVERRIDES))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    images = (rng.rand(2, 96, 128, 3) * 255).astype(np.float32)
    gt = np.zeros((2, 4, 5), np.float32)
    gt[..., 4] = -1
    gt[0, :3] = [[10, 12, 60, 50, 0], [40, 30, 120, 90, 2],
                 [70, 5, 110, 40, 1]]
    gt[1, :2] = [[5, 5, 90, 80, 1], [60, 40, 125, 95, 0]]
    return {"image": images, "gt_boxes": gt}


@pytest.fixture(scope="module")
def variables(config, batch):
    """JAX random init, with the heads rescaled to unsaturated logits."""
    init = JaxFasterRCNN(config).init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 96, 128, 3)))
    variables = jax.tree_util.tree_map(np.array, init)
    params = variables["params"]

    def port_forward():
        port = load_flax_variables(FasterRCNN(config), variables).eval()
        with torch.inference_mode():
            return port(torch.from_numpy(batch["image"]))

    rpn = port_forward()["rpn_prediction"]
    params["rpn"]["cls_conv"]["kernel"] *= 3.0 / float(
        rpn["rpn_cls_score"].std())
    rcnn = port_forward()["classification_prediction"]["rcnn"]
    params["rcnn"]["fc_classifier"]["kernel"] *= 3.0 / float(
        rcnn["cls_score"].std())
    params["rcnn"]["fc_bbox"]["kernel"] *= 0.5 / float(
        rcnn["bbox_offsets"].std())
    return variables


@pytest.fixture(scope="module")
def jax_run(config, batch, variables):
    """Two JAX train steps: (metrics, params) after each, plus targets."""
    model = KeyedFasterRCNN(config)
    params = variables["params"]
    mask = jax_training.build_trainable_mask(params, config.model)
    coeffs = jax_training.build_weight_decay_coefficients(params,
                                                          config.model)
    tx, _ = jax_training.get_optimizer(
        config.train, trainable_mask=mask, weight_decay=coeffs,
        weight_decay_mask=jax_training.build_weight_decay_mask(params))
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                       opt_state=tx.init(params),
                       batch_stats=variables["batch_stats"])
    step = jax_step(model, tx, trainable_mask=mask, reg_fn=lambda p: (
        jax_training.l2_regularization_loss(p, coeffs)))
    device_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    targets = model.apply(variables, device_batch["image"],
                          gt_boxes=device_batch["gt_boxes"], train=True)
    results = []
    for _ in range(2):
        state, metrics = step(state, device_batch, jax.random.PRNGKey(9))
        results.append((
            {k: float(v) for k, v in metrics.items()},
            jax.tree_util.tree_map(np.asarray, state.params),
        ))
    return results, targets


class TestTrainStep:
    def _port(self, config, variables):
        model = load_flax_variables(FasterRCNN(config), variables)
        mask = training.build_trainable_mask(model, config.model)
        for name, p in model.named_parameters():
            p.requires_grad_(mask[name])
        params = dict(model.named_parameters())
        decay = training.build_weight_decay_coefficients(model, config.model)
        optimizer, _ = training.get_optimizer(config.train, params, mask,
                                              decay)
        step = trainer.make_train_step(
            model, optimizer,
            reg_fn=lambda: training.l2_regularization_loss(params, decay))
        return model, step

    def test_targets_match_jax(self, config, batch, variables, jax_run):
        want = jax_run[1]
        model, _ = self._port(config, variables)
        model.train()
        with torch.no_grad():
            got = model(torch.from_numpy(batch["image"]),
                        gt_boxes=torch.from_numpy(batch["gt_boxes"]),
                        priorities=port_priorities(2, 576, 32))
        rpn_got, rpn_want = got["rpn_prediction"], want["rpn_prediction"]
        np.testing.assert_array_equal(rpn_got["rpn_cls_target"].numpy(),
                                      np.asarray(rpn_want["rpn_cls_target"]))
        np.testing.assert_allclose(rpn_got["rpn_bbox_target"].numpy(),
                                   np.asarray(rpn_want["rpn_bbox_target"]),
                                   rtol=1e-6, atol=1e-6)
        t_got = got["classification_prediction"]["target"]
        t_want = want["classification_prediction"]["target"]
        np.testing.assert_array_equal(t_got["cls"].numpy(),
                                      np.asarray(t_want["cls"]))
        np.testing.assert_array_equal(t_got["selected_mask"].numpy(),
                                      np.asarray(t_want["selected_mask"]))
        np.testing.assert_allclose(t_got["bbox_offsets"].numpy(),
                                   np.asarray(t_want["bbox_offsets"]),
                                   rtol=1e-5, atol=1e-5)
        assert (t_got["cls"] > 0).any() and (t_got["cls"] == 0).any()
        assert "objects" not in got["classification_prediction"]

    def test_two_steps_match_jax(self, config, batch, variables, jax_run):
        model, step = self._port(config, variables)
        device_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        priorities = port_priorities(2, 576, 32)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        for i, (want_metrics, want_params) in enumerate(jax_run[0]):
            metrics = step(device_batch, i, None, priorities)
            assert set(metrics) == set(want_metrics)
            for key, value in want_metrics.items():
                np.testing.assert_allclose(float(metrics[key]), value,
                                           rtol=LOSS_RTOL, err_msg=key)
            want = torch_state_from_flax({"params": want_params})
            for name, p in model.named_parameters():
                np.testing.assert_allclose(
                    p.detach().numpy(), want[name].numpy(), rtol=PARAM_RTOL,
                    atol=PARAM_ATOL, err_msg=name)
        moved = {n for n, p in model.named_parameters()
                 if not torch.equal(p, before[n])}
        frozen = {n for n, p in model.named_parameters()
                  if not p.requires_grad}
        assert frozen and not moved & frozen
        assert any("block1" in n for n in frozen)
        assert any("block2" in n for n in moved)

    def test_uint8_images_are_cast_on_the_device(self, config, batch,
                                                  variables):
        metrics = []
        for dtype in (np.float32, np.uint8):
            _, step = self._port(config, variables)
            images = np.round(batch["image"]).astype(dtype)
            metrics.append(step({"image": torch.from_numpy(images),
                                 "gt_boxes": torch.from_numpy(
                                     batch["gt_boxes"])},
                                0, None, port_priorities(2, 576, 32)))
        assert float(metrics[0]["total_loss"]) == float(
            metrics[1]["total_loss"])


class TestModel:
    def test_rcnn_loss_sends_no_gradient_to_the_rpn_boxes(self, config,
                                                           batch, variables):
        """The proposals carry no gradient, as in the JAX model: a loss on
        the RCNN outputs alone leaves the RPN's box regressor untouched."""
        model = load_flax_variables(FasterRCNN(config), variables).train()
        preds = model(torch.from_numpy(batch["image"]),
                      gt_boxes=torch.from_numpy(batch["gt_boxes"]),
                      priorities=port_priorities(2, 576, 32))
        rcnn = preds["classification_prediction"]["rcnn"]
        (rcnn["cls_score"].sum() + rcnn["bbox_offsets"].sum()).backward()
        grad = model.rpn.bbox_conv.weight.grad
        assert grad is None or not grad.any()
        assert model.base_network_tail.resnet_v1_50.block4.unit_1.conv1 \
            .weight.grad.abs().sum() > 0
        assert preds["rpn_prediction"]["proposals"].grad_fn is None

    def test_gradients_flow_through_the_compute_dtype_casts(self, config):
        model = FasterRCNN(config, dtype=torch.bfloat16)
        load_flax_variables(model, _random_variables(config))
        x = torch.rand(1, 64, 64, 3) * 255
        model.base_network(x).float().sum().backward()
        conv = model.base_network.resnet_v1_50.block3.unit_1.conv1
        assert conv.weight.grad.dtype == torch.float32
        assert conv.weight.grad.abs().sum() > 0

    def test_dropout_only_in_training(self, config):
        cfg = Config(dict(config))
        cfg.model = Config(dict(config.model))
        cfg.model.rcnn = Config({**dict(config.model.rcnn),
                                 "dropout_keep_prob": 0.5,
                                 "layer_sizes": [64]})
        model = FasterRCNN(cfg)
        head = model.rcnn
        features = torch.ones(4000, 1, 1, 2048)
        generator = torch.Generator().manual_seed(0)
        head.train()
        net = head._dropout(features.mean(dim=(1, 2)), generator)
        kept = (net != 0).float().mean()
        assert abs(float(kept) - 0.5) < 0.01
        assert set(net.unique().tolist()) == {0.0, 2.0}
        head.eval()
        assert torch.equal(head._dropout(features.mean(dim=(1, 2)), None),
                           features.mean(dim=(1, 2)))


def _random_variables(config):
    from luminoth_tpu_torch.utils.weights import init_variables

    return init_variables(config, seed=1)


def write_records(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_integration import write_dataset

    return write_dataset(tmp_path, n=4)


class TestRun:
    def _config(self, tmp_path, data_dir, **train):
        cfg = torch_config.get_model_config(
            torch_config.get_base_config("fasterrcnn"), Config({
                "train": {"job_dir": str(tmp_path / "jobs"), "run_name": "r",
                          "batch_size": 2, "seed": 3, "clip_by_norm": True,
                          "learning_rate": {"learning_rate": 1e-4},
                          "save_summaries_steps": 1, **train},
                "dataset": {"dir": data_dir, "image_preprocessing": {
                    "min_size": 96, "max_size": 128,
                    "canvas_height": 96, "canvas_width": 128}},
                "model": {"network": {"num_classes": 2},
                          "base_network": {"architecture": "resnet_v1_50"},
                          "rpn": {"proposals": {"pre_nms_top_n": 128,
                                                "post_nms_top_n": 32}}},
            }))
        return cfg

    def test_trains_checkpoints_and_resumes(self, tmp_path):
        cfg = self._config(tmp_path, write_records(tmp_path))
        state = trainer.run(cfg, max_steps=2, device="cpu")
        assert state.step == 2 and len(state.history) == 2
        assert all(np.isfinite(h["total_loss"]) for h in state.history)
        assert {"no_reg_loss", "reg_loss", "grad_norm"} <= set(
            state.history[0])
        ckpt = tmp_path / "jobs" / "r" / "ckpt"
        assert sorted(os.listdir(ckpt)) == ["ckpt_step_2.pt"]
        saved = torch.load(ckpt / "ckpt_step_2.pt", weights_only=True)
        assert saved["step"] == 2 and saved["optimizer"]["count"] == 2
        for name, value in state.model.state_dict().items():
            assert torch.equal(saved["model"][name], value), name

        resumed = trainer.run(cfg, max_steps=3, device="cpu")
        assert resumed.step == 3 and len(resumed.history) == 1
        assert sorted(os.listdir(ckpt)) == ["ckpt_step_3.pt"]
        # One more step from the saved weights: trainable parameters move,
        # frozen ones keep the saved values.
        for name, p in resumed.model.named_parameters():
            assert torch.equal(p, saved["model"][name]) != p.requires_grad, (
                name)

    def test_cli_trains(self, tmp_path):
        data_dir = write_records(tmp_path)
        config_path = tmp_path / "config.yml"
        import yaml

        config_path.write_text(yaml.safe_dump({
            "train": {"batch_size": 2, "run_name": "cli",
                      "learning_rate": {"learning_rate": 1e-4}},
            "dataset": {"dir": data_dir, "image_preprocessing": {
                "min_size": 96, "max_size": 128,
                "canvas_height": 96, "canvas_width": 128}},
            "model": {"type": "fasterrcnn", "network": {"num_classes": 2},
                      "base_network": {"architecture": "resnet_v1_50"},
                      "rpn": {"proposals": {"pre_nms_top_n": 64,
                                            "post_nms_top_n": 16}}},
        }))
        out = subprocess.run(
            [sys.executable, "-m", "luminoth_tpu_torch.train", "-c",
             str(config_path), "--job-dir", str(tmp_path / "jobs"),
             "--max-steps", "1", "--device", "cpu"],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=300,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        assert "step: 1," in out.stderr
        assert (tmp_path / "jobs" / "cli" / "ckpt" / "ckpt_step_1.pt").exists()

    @pytest.mark.parametrize("knob", [
        {"spatial_shards": 2}, {"full_trace": True}, {"save_timeline": True},
        {"tf_debug": True}, {"remat": True}, {"ignore_scope": "rpn"},
    ])
    def test_unported_knobs_raise(self, tmp_path, knob):
        cfg = self._config(tmp_path, str(tmp_path), **knob)
        with pytest.raises(NotImplementedError):
            trainer.run(cfg, max_steps=1, device="cpu")

    @pytest.mark.parametrize("flag", ["train_batch_norm", "remat"])
    def test_unported_base_network_flags_raise(self, tmp_path, flag):
        cfg = self._config(tmp_path, str(tmp_path))
        cfg.model.base_network[flag] = True
        with pytest.raises(NotImplementedError):
            trainer.run(cfg, max_steps=1, device="cpu")

    def test_more_than_one_device_raises(self, tmp_path):
        cfg = self._config(tmp_path, str(tmp_path))
        with pytest.raises(NotImplementedError):
            trainer.run(cfg, max_steps=1, device=["cpu", "cpu"])

    def test_pretrained_backbone_merges_matching_paths(self, tmp_path,
                                                       config):
        from luminoth_tpu_torch.utils.weights import (
            flatten_variables,
            init_variables,
        )

        variables = flatten_variables(init_variables(config, seed=1))
        other = flatten_variables(init_variables(config, seed=2))
        backbone = {k: v for k, v in other.items() if "/base_network/" in k}
        key = "params/rpn/conv/kernel"
        backbone[key] = other[key][:1]  # wrong shape: skipped
        path = tmp_path / "backbone.npz"
        np.savez(path, **backbone)
        cfg = Config(dict(config))
        cfg.model = Config(dict(config.model))
        cfg.model.base_network = Config(
            {**dict(config.model.base_network), "weights": str(path)})
        merged = trainer.load_pretrained_backbone(variables, cfg)
        for name, value in merged.items():
            want = other if name in backbone and name != key else variables
            np.testing.assert_array_equal(value, want[name], err_msg=name)

        # torchvision-layout weights need torchvision_compat (the JAX
        # package's ValueError; tests/test_torch_zoo.py loads them).
        np.savez(path, **backbone, **{"__meta__/layout": "torchvision"})
        with pytest.raises(ValueError, match="torchvision_compat"):
            trainer.load_pretrained_backbone(variables, cfg)

    def test_synthetic_records_read_back(self, tmp_path):
        from luminoth_tpu.formats.example_pb import decode_sequence_example
        from luminoth_tpu.formats.tfrecord import read_tfrecords
        from luminoth_tpu_torch.utils.synthetic import (
            write_synthetic_records,
        )

        data_dir, boxes = write_synthetic_records(
            str(tmp_path), 3, num_classes=5, seed=7, height=48, width=64)
        records = list(read_tfrecords(os.path.join(data_dir,
                                                   "train.tfrecords")))
        assert len(records) == len(boxes) == 3
        for i, (record, want) in enumerate(zip(records, boxes)):
            context, lists = decode_sequence_example(record)
            assert (context["height"], context["width"]) == ([48], [64])
            assert 2 <= len(want) <= 6
            assert (want[:, 4] >= 0).all() and (want[:, 4] < 5).all()
            assert (want[:, 2] <= 64).all() and (want[:, 3] <= 48).all()
            for col, name in enumerate(("xmin", "ymin", "xmax", "ymax",
                                        "label")):
                assert [v[0] for v in lists[name]] == want[:, col].tolist()
            image = np.asarray(Image.open(io.BytesIO(
                bytes(context["image_raw"][0]))))
            assert image.shape == (48, 64, 3)
        with open(os.path.join(data_dir, "classes.json")) as f:
            assert len(json.load(f)) == 5

    def test_chip_smoke_imports_only_the_port(self):
        import ast

        with open(os.path.join(REPO, "chip_smoke.py")) as f:
            tree = ast.parse(f.read())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names.update(alias.name for alias in node.names)
            elif isinstance(node, ast.ImportFrom):
                names.add(node.module or "")
        assert "luminoth_tpu_torch.train" in names
        bad = sorted(n for n in names if n.split(".")[0] in (
            "luminoth_tpu", "jax", "jaxlib", "flax", "optax"))
        assert bad == []

    def test_train_module_imports_no_jax(self):
        code = (
            "import sys\n"
            "import luminoth_tpu_torch.train\n"
            "bad = sorted(n for n in sys.modules\n"
            "             if n.split('.')[0] in ('luminoth_tpu', 'jax',"
            " 'flax', 'jaxlib', 'optax'))\n"
            "print(bad)\n"
        )
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
            text=True, timeout=120,
        )
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "[]"
