"""The port's SSD training, eval and ``predict`` against the JAX package
(CPU).

SSD with the base config's widths and training defaults (momentum 0.5 at
3e-4, weight decay 5e-4 on kernels), 3 classes, the 300x300 input. One
train step of ``train.make_train_step`` against the JAX
``make_train_step`` at batch 1: the losses and the gradient norm within
1e-5 relative, the parameters after the step within atol 1e-6 + rtol
1e-5 (the heads and extras) or their update within 1e-2 of its norm (the
VGG-16 trunk, whose float32 gradients are that far from float64 ones). ``train.run`` trains from synthetic TFRecords (the base config's
augmentations on) and checkpoints. ``evaluate_once`` against the JAX one
on 3 synthetic images at batch 2 (the last batch padded; the eval
mutations move SSD to the per-class detection path): the detections of
every batch equal (boxes within 1e-2 px, probabilities within 1e-5), AP/AR
within 1e-6, the losses within 1e-5 relative. The ``predict`` command's
JSON lines against the JAX command's, from a JAX checkpoint.
"""

import functools
import io
import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from click.testing import CliRunner
from PIL import Image

from luminoth_tpu import eval as jax_eval
from luminoth_tpu import predict as jax_predict
from luminoth_tpu.models.ssd import SSD as JaxSSD
from luminoth_tpu.train import TrainState, make_train_step as jax_step
from luminoth_tpu.utils import checkpoint_io as jax_checkpoint_io
from luminoth_tpu.utils import training as jax_training
from luminoth_tpu.utils.config import get_config as jax_get_config
from luminoth_tpu.utils.config import to_plain
from luminoth_tpu.utils.predicting import PredictorNetwork as JaxPredictor
from luminoth_tpu_torch import eval as port_eval
from luminoth_tpu_torch import predict as port_predict
from luminoth_tpu_torch import train as trainer
from luminoth_tpu_torch.models.ssd import SSD
from luminoth_tpu_torch.tasks import Detector
from luminoth_tpu_torch.tools.server import web
from luminoth_tpu_torch.utils import training
from luminoth_tpu_torch.utils.config import get_config
from luminoth_tpu_torch.utils.predicting import PredictorNetwork
from luminoth_tpu_torch.utils.synthetic import write_synthetic_records
from luminoth_tpu_torch.utils.weights import (
    init_variables,
    load_flax_variables,
    torch_state_from_flax,
)
from test_torch_eval import assert_metrics_equal
from test_torch_isolation import (  # noqa: F401
    few_threads,
    jax_cache_isolation,
    lumi_home_isolation,
)
from test_torch_serve import multipart
from test_torch_slice import assert_detections_equal
from test_torch_ssd import GT, assert_objects_close, jax_variables

LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
# VGG-16 trains from conv1_1 at 300x300: there the float32 gradient is
# itself 3e-3 to 6e-3 (relative norm) from the float64 one (the port
# against itself on this image), so its updates agree to that, not to 1e-5.
VGG_UPDATE_RTOL = 1e-2
IMAGES, BATCH, STEP = 3, 2, 5


def write_config(path, **sections):
    config = {"model": {"type": "ssd", "network": {"num_classes": 3}}}
    for name, values in sections.items():
        config.setdefault(name, {}).update(values)
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return str(path)


@pytest.fixture(scope="module")
def ssd_job(tmp_path_factory):
    """A config file, 3 synthetic val images, random weights and a JAX
    checkpoint of them under ``job_dir/small/ckpt``."""
    root = tmp_path_factory.mktemp("ssd")
    data_dir, _ = write_synthetic_records(
        str(root / "data"), IMAGES, 3, seed=11, height=120, width=160,
        split="val")
    job_dir = root / "jobs"
    path = write_config(
        root / "ssd.yml",
        train={"batch_size": BATCH, "job_dir": str(job_dir),
               "run_name": "small"},
        dataset={"dir": data_dir})
    config = get_config(path)
    variables = jax_variables(config, init_variables(config, seed=0))
    params = variables["params"]
    jax_checkpoint_io.CheckpointManager(
        str(job_dir / "small" / "ckpt")).save(
        TrainState(step=jnp.asarray(STEP, jnp.int32), params=params,
                   opt_state=optax.adam(1e-3).init(params), batch_stats={}),
        STEP)
    return {"path": path, "root": root, "variables": variables}


# ------------------------------------------------------------ train step


def test_train_step_matches_jax(ssd_job):
    config = get_config(ssd_job["path"])
    variables = ssd_job["variables"]
    rng = np.random.RandomState(2)
    batch = {"image": (rng.rand(1, 300, 300, 3) * 255).astype(np.float32),
             "gt_boxes": GT[:1]}

    params = variables["params"]
    mask = jax_training.build_trainable_mask(params, config.model)
    coeffs = jax_training.build_weight_decay_coefficients(params,
                                                          config.model)
    tx, _ = jax_training.get_optimizer(
        config.train, trainable_mask=mask, weight_decay=coeffs,
        weight_decay_mask=jax_training.build_weight_decay_mask(params))
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                       opt_state=tx.init(params), batch_stats={})
    step = jax_step(JaxSSD(to_plain(config)), tx, trainable_mask=mask,
                    reg_fn=lambda p: jax_training.l2_regularization_loss(
                        p, coeffs))
    state, want_metrics = step(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(9))
    want_params = torch_state_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, state.params)})

    model = load_flax_variables(SSD(config), variables)
    port_mask = training.build_trainable_mask(model, config.model)
    assert all(port_mask.values())  # SSD trains every parameter
    named = dict(model.named_parameters())
    decay = training.build_weight_decay_coefficients(model, config.model)
    optimizer, _ = training.get_optimizer(config.train, named, port_mask,
                                          decay)
    port_step = trainer.make_train_step(
        model, optimizer,
        reg_fn=lambda: training.l2_regularization_loss(named, decay))
    metrics = port_step({k: torch.from_numpy(v) for k, v in batch.items()},
                        0, None)

    assert set(metrics) == set(want_metrics)
    for key, value in want_metrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(value),
                                   rtol=LOSS_RTOL, err_msg=key)
    assert float(metrics["bbox_loss"]) > 0
    before = torch_state_from_flax(variables)
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        want = want_params[name].numpy()
        if "vgg_16" in name:
            update = want - before[name].numpy()
            assert np.linalg.norm(got - want) <= (
                VGG_UPDATE_RTOL * np.linalg.norm(update)), name
        else:
            np.testing.assert_allclose(got, want, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=name)


def test_run_trains_and_checkpoints(tmp_path):
    """``train.run`` on SSD: 2 steps from synthetic records with the base
    config's augmentations, finite losses, a checkpoint the predictor
    loads; a training forward makes no detections."""
    data_dir, _ = write_synthetic_records(str(tmp_path / "data"), 4, 3,
                                          seed=5, height=120, width=160)
    path = write_config(
        tmp_path / "train.yml",
        train={"batch_size": 2, "job_dir": str(tmp_path / "jobs"),
               "run_name": "run", "seed": 3},
        dataset={"dir": data_dir})
    config = get_config(path)
    state = trainer.run(config, max_steps=2, device="cpu")
    assert state.step == 2 and len(state.history) == 2
    for h in state.history:
        assert np.isfinite(h["total_loss"]) and h["total_loss"] > 0
        assert {"cls_loss", "bbox_loss", "reg_loss"} <= set(h)
    assert os.path.exists(tmp_path / "jobs" / "run" / "ckpt" /
                          "ckpt_step_2.pt")
    predictor = PredictorNetwork(config, device="cpu")
    assert torch.equal(
        predictor._model.feature_extractor.conv7.weight,
        state.model.feature_extractor.conv7.weight)

    state.model.train()
    with torch.no_grad():
        preds = state.model(torch.zeros(1, 300, 300, 3),
                            gt_boxes=torch.from_numpy(GT[:1]))
    assert "classification_prediction" not in preds and "target" in preds


# ------------------------------------------------------------------ eval


def test_eval_mutations_move_ssd_to_the_per_class_path(ssd_job):
    config = port_eval.apply_eval_config_mutations(
        get_config(ssd_job["path"]), "val", max_detections=50)
    jax_config = jax_eval.apply_eval_config_mutations(
        jax_get_config([ssd_job["path"]]), "val", max_detections=50)
    assert to_plain(config) == to_plain(jax_config)
    proposals = config.model.proposals
    assert proposals.min_prob_threshold == 0.0
    assert proposals.total_max_detections == 50


def test_evaluate_once_equals_jax(ssd_job):
    path = ssd_job["path"]
    config = port_eval.apply_eval_config_mutations(get_config(path), "val")
    jax_config = jax_eval.apply_eval_config_mutations(
        jax_get_config([path]), "val")
    variables = ssd_job["variables"]
    jax_forward = jax_eval._build_forward(JaxSSD(to_plain(jax_config)))
    jax_outs, port_outs = [], []

    def jax_recording(*args):
        outs = jax_forward(*args)
        jax_outs.append([np.asarray(t) for t in outs[:4]])
        return outs

    def port_recording(*args):
        outs = port_eval.eval_forward(*args)
        port_outs.append([t.numpy() for t in outs[:4]])
        return outs

    want = jax_eval.evaluate_once(jax_config, None, variables,
                                  forward=jax_recording)
    model = load_flax_variables(SSD(config), variables)
    got = port_eval.evaluate_once(config, model, forward=port_recording)
    assert got["images"] == IMAGES  # the padded row counted once
    assert_metrics_equal(got, want)
    assert len(port_outs) == len(jax_outs) == 2
    for outs, want_outs in zip(port_outs, jax_outs):
        names = ("objects", "labels", "probs", "valid")
        assert_detections_equal(dict(zip(names, outs)),
                                dict(zip(names, want_outs)))
        # Per class: every class keeps detections at a zero floor.
        assert len(np.unique(outs[1][outs[3]])) == 3


# --------------------------------------------------------------- predict


def test_predict_command_equals_jax(ssd_job, tmp_path, monkeypatch):
    """The JSON lines of the port's ``predict --config`` against the JAX
    command's (its predictor on one device), both from the JAX
    checkpoint."""
    monkeypatch.setattr(jax_predict, "PredictorNetwork",
                        functools.partial(JaxPredictor, mesh=None))
    rng = np.random.default_rng(4)
    paths = []
    for i, size in enumerate(((200, 260), (310, 240))):
        path = tmp_path / f"img{i}.jpg"
        Image.fromarray(rng.integers(0, 256, size + (3,), dtype=np.uint8)
                        ).save(path, quality=90)
        paths.append(str(path))
    args = [*paths, "-c", ssd_job["path"], "--min-prob", "0.3"]
    outputs = {}
    for name, command, extra in (("jax", jax_predict.predict, []),
                                 ("port", port_predict.predict,
                                  ["--device", "cpu"])):
        out = tmp_path / f"{name}.jsonl"
        result = CliRunner().invoke(command, args + extra + ["-f", str(out)])
        assert result.exit_code == 0, result.output
        outputs[name] = [json.loads(line) for line in
                         out.read_text().splitlines()]
    assert [r["file"] for r in outputs["port"]] == paths
    assert [r["file"] for r in outputs["jax"]] == paths
    for got, want in zip(outputs["port"], outputs["jax"]):
        assert_objects_close(got["objects"], want["objects"])
        assert min(o["prob"] for o in got["objects"]) >= 0.3


def test_web_server_serves_ssd(ssd_job, monkeypatch):
    """The ``server web`` command lowers SSD's score floor for the page,
    and a POST to ``/api/ssd/predict/`` answers ``Detector.predict``."""
    captured = {}
    monkeypatch.setattr(web, "run_server",
                        lambda config, **kwargs: captured.update(config))
    result = CliRunner().invoke(web.web, ["-c", ssd_job["path"],
                                          "--device", "cpu"])
    assert result.exit_code == 0, result.output
    assert captured["model"]["proposals"]["min_prob_threshold"] == (
        web.MIN_PROB_FOR_FRONTEND)
    monkeypatch.undo()

    config = get_config(ssd_job["path"])
    httpd = web.run_server(config, port=0, block=False, batch_size=2,
                           device="cpu")
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(6).integers(
        0, 256, (200, 240, 3), dtype=np.uint8)).save(buf, "JPEG")
    try:
        assert httpd.state.ready.wait(120)
        body, content_type = multipart(buf.getvalue())
        request = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/api/ssd/predict/",
            data=body, method="POST",
            headers={"Content-Type": content_type})
        with urllib.request.urlopen(request, timeout=120) as response:
            status, payload = response.status, json.load(response)
    finally:
        web.stop_server(httpd)
    image = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    want = Detector(config=ssd_job["path"], device="cpu",
                    prob=0.0).predict(image)
    assert status == 200
    assert payload["objects"] == want and len(want) > 0
