"""The port's training knobs against the JAX package (CPU).

* The batch norm in training mode against flax's ``nn.BatchNorm`` (the
  JAX package's ``_BatchNorm``) on random inputs, float32 and bfloat16:
  the output, the gradients of the input, scale and bias, and the updated
  ``batch_stats``, to rtol 1e-5 and atol 1e-6 (of the largest magnitude),
  the tolerances of ``tests/test_torch_train.py``'s step test; in
  bfloat16 the output and the input's gradient, rounded to bfloat16 last,
  to one bfloat16 ulp (rtol 2^-7, atol 2^-8 of the largest magnitude).
* ``train_batch_norm`` with ``remat``: two train steps of the port's
  ``make_train_step`` against the JAX ``make_train_step(train_batch_norm=
  True, remat=True)`` on Faster R-CNN ResNet-50 v1 (the setting of
  ``tests/test_torch_train.py``: 3 classes, a 2 x 96 x 128 canvas, fixed
  subsampling keys), each step from the JAX state before it. Here the
  step test's tolerances cannot hold, and the cause is the arithmetic,
  not the port: with batch statistics each of the trunk's ~50 batch norms
  renormalises, so the ~1e-6 difference between oneDNN's and XLA's
  convolutions grows by ~1.2x per batch norm (1.5e-7 after the root's,
  3e-4 on the block3 map; JAX against itself, jit against eager, differs
  by 3.4e-5 there), and the backward through batch statistics subtracts
  the cotangent's mean and its projection on the normalised input,
  leaving trunk gradients ~300x smaller than with fixed statistics, whose
  relative error grows by that factor (a few % per tensor; the heads'
  gradients agree to ~3e-4). So, per step: the losses and the gradient
  norm to 5e-3 relative (measured: 6.4e-4); every ``batch_stats``
  tensor's move to 1e-2 of the move (measured: 7.2e-4); each RPN and
  RCNN head parameter's move to 1e-2 (measured: 8.3e-4), and all the
  trainable parameters' moves together to 0.2 (measured: 0.042). A batch
  norm on its running statistics, or a second update of them, misses
  these by far.
* ``remat`` on against off in the port: bitwise equal on the CPU, with the
  running statistics moved once per step although the units run twice.
* VGG-16 (Faster R-CNN) and SSD's truncated VGG-16 are unchanged by both
  flags.
* ``ignore_scope``: a JAX-written msgpack restored by the port as JAX
  ``CheckpointManager.restore_latest(ignore_scope=)`` restores it
  (parameters, batch statistics, optimizer state, step, exactly); a port
  ``.pt``; a shape mismatch; the optimizer state of an ignored tensor.
* ``tf_debug``: a NaN-poisoned weight raises ``FloatingPointError`` at
  step 1 in both packages' ``train.run``.
* ``full_trace``: a ``torch.profiler`` trace under ``run_dir/profile``
  after 6 steps.
"""

import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from luminoth_tpu import train as jax_train
from luminoth_tpu.train import TrainState, make_train_step as jax_step
from luminoth_tpu.utils import training as jax_training
from luminoth_tpu.utils.checkpoint_io import (
    CheckpointManager as JaxCheckpointManager,
)
from luminoth_tpu.utils.config import Config, get_config as jax_get_config
from luminoth_tpu_torch import train as trainer
from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN
from luminoth_tpu_torch.models.ssd import SSD
from luminoth_tpu_torch.utils import config as torch_config
from luminoth_tpu_torch.utils import training
from luminoth_tpu_torch.utils.checkpoint_io import (
    CheckpointManager,
    merge_train_state,
)
from luminoth_tpu_torch.utils.weights import (
    flatten_variables,
    flax_paths,
    init_variables,
    load_flax_variables,
    nest_variables,
    torch_state_from_flax,
)
from test_torch_isolation import (  # noqa: F401
    few_threads,
    jax_cache_isolation,
    lumi_home_isolation,
)
from test_torch_train import (
    OVERRIDES,
    drop_checkpoints,
    PARAM_ATOL,
    PARAM_RTOL,
    KeyedFasterRCNN,
    port_priorities,
    rescaled_variables,
    train_batch,
    write_records,
)

# The step's tolerances under batch statistics (see the docstring).
KNOBS_LOSS_RTOL = 5e-3
STATS_MOVE_RTOL = 1e-2
HEAD_MOVE_RTOL, ALL_MOVES_RTOL = 1e-2, 0.2
KNOBS = {"train_batch_norm": True, "remat": True}


def knob_config(**base_network):
    config = torch_config.get_model_config(
        torch_config.get_base_config("fasterrcnn"), Config(OVERRIDES))
    config.model.base_network.update(base_network)
    return config


@pytest.fixture(scope="module")
def config():
    return knob_config(**KNOBS)


@pytest.fixture(scope="module")
def batch():
    return train_batch()


@pytest.fixture(scope="module")
def variables(config, batch):
    """The port's random init in the JAX layout, heads rescaled."""
    return rescaled_variables(config, batch, init=nest_variables(
        flatten_variables(init_variables(config, seed=0))))


def jax_optimizer(config, params):
    mask = jax_training.build_trainable_mask(params, config.model)
    coeffs = jax_training.build_weight_decay_coefficients(params,
                                                          config.model)
    tx, _ = jax_training.get_optimizer(
        config.train, trainable_mask=mask, weight_decay=coeffs,
        weight_decay_mask=jax_training.build_weight_decay_mask(params))
    return tx, mask, coeffs


def jax_state(config, variables):
    tx, mask, coeffs = jax_optimizer(config, variables["params"])
    return TrainState(step=jnp.asarray(0, jnp.int32),
                      params=variables["params"],
                      opt_state=tx.init(variables["params"]),
                      batch_stats=variables["batch_stats"])


@pytest.fixture(scope="module")
def jax_run(config, batch, variables):
    """Two JAX steps with both flags: the metrics of each, and the train
    state (a state dict, numpy leaves) before the first and after each.
    One compile serves both flags."""
    model = KeyedFasterRCNN(config)
    tx, mask, coeffs = jax_optimizer(config, variables["params"])
    state = jax_state(config, variables)
    step = jax_step(model, tx, train_batch_norm=True, remat=True,
                    trainable_mask=mask, reg_fn=lambda p: (
                        jax_training.l2_regularization_loss(p, coeffs)))
    device_batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def state_dict(state):
        return serialization.to_state_dict(
            jax.tree_util.tree_map(np.asarray, state))

    metrics, states = [], [state_dict(state)]
    for _ in range(2):
        state, out = step(state, device_batch, jax.random.PRNGKey(9))
        metrics.append({k: float(v) for k, v in out.items()})
        states.append(state_dict(state))
    return metrics, states, jax.tree_util.tree_map(np.asarray, state)


def port_step(config, variables):
    """The port's model, optimizer and train step from ``variables``."""
    model = load_flax_variables(FasterRCNN(config), variables)
    mask = training.build_trainable_mask(model, config.model)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    params = dict(model.named_parameters())
    decay = training.build_weight_decay_coefficients(model, config.model)
    optimizer, _ = training.get_optimizer(config.train, params, mask, decay)
    step = trainer.make_train_step(
        model, optimizer,
        reg_fn=lambda: training.l2_regularization_loss(params, decay))
    return model, optimizer, step


def buffers(model):
    return {name: b.clone() for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))}


def _relative(got, want):
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 6, 8, 64), (32, 7, 7, 128)])
def test_batch_norm_matches_flax(shape, dtype):
    """One batch norm in training mode: flax's ``_BatchNorm(train=True)``
    of the JAX package against the port's ``BatchNorm`` with
    ``train_batch_norm``, on the same NHWC input (channels_last NCHW in the
    port), scale, bias and output cotangent."""
    from luminoth_tpu.models.base.resnet import _BatchNorm

    from luminoth_tpu_torch.models.base.resnet import BatchNorm

    rng = np.random.default_rng(sum(shape))
    channels = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1.5).astype(np.float32)
    cotangent = rng.standard_normal(shape).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(channels)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(channels)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(channels)).astype(np.float32)
    var = (1 + 0.1 * rng.random(channels)).astype(np.float32)
    jax_dtype = getattr(jnp, dtype)
    module = _BatchNorm(True, jax_dtype)

    def apply(x, params):
        y, state = module.apply(
            {"params": params,
             "batch_stats": {"BatchNorm": {"mean": mean, "var": var}}},
            x.astype(jax_dtype), mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cotangent), (y, state)

    params = {"BatchNorm": {"scale": scale, "bias": bias}}
    (_, (y, state)), (gx, gp) = jax.value_and_grad(
        apply, argnums=(0, 1), has_aux=True)(jnp.asarray(x), params)

    bn = BatchNorm(channels).train()
    bn.train_batch_norm = True
    with torch.no_grad():
        for name, value in (("weight", scale), ("bias", bias),
                            ("running_mean", mean), ("running_var", var)):
            getattr(bn, name).copy_(torch.from_numpy(value))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    yt = bn(xt.to(getattr(torch, dtype)))
    assert yt.dtype == getattr(torch, dtype)
    (yt.float() * torch.from_numpy(cotangent).permute(0, 3, 1, 2)).sum(
        ).backward()

    def close(got, want, name):
        want = np.asarray(want, np.float32)
        got = np.asarray(got, np.float32)
        if dtype == "bfloat16" and name in ("y", "grad x"):
            # rounded to bfloat16 last: one bf16 ulp apart where the
            # float32 values straddle a rounding boundary
            np.testing.assert_allclose(
                got, want, rtol=2.0 ** -7,
                atol=2.0 ** -8 * float(np.abs(want).max()), err_msg=name)
            return
        np.testing.assert_allclose(
            got, want, rtol=PARAM_RTOL,
            atol=PARAM_ATOL * float(np.abs(want).max()), err_msg=name)

    nhwc = (0, 2, 3, 1)
    close(yt.detach().float().permute(*nhwc).numpy(),
          np.asarray(y.astype(jnp.float32)), "y")
    close(xt.grad.permute(*nhwc).numpy(), gx, "grad x")
    close(bn.weight.grad.numpy(), gp["BatchNorm"]["scale"], "grad scale")
    close(bn.bias.grad.numpy(), gp["BatchNorm"]["bias"], "grad bias")
    stats = state["batch_stats"]["BatchNorm"]
    close(bn.running_mean.numpy(), stats["mean"], "mean")
    close(bn.running_var.numpy(), stats["var"], "var")


class TestBatchNormAndRemat:
    def test_two_steps_match_jax(self, config, batch, variables, jax_run):
        """Each step from the JAX state before it (the second from JAX's
        first, optimizer trace included), so that one step's error does
        not feed the next; the moves of both packages compared."""
        model, optimizer, step = port_step(config, variables)
        assert model.base_network.resnet_v1_50.remat
        paths = flax_paths(model)
        initial = {k: v.clone() for k, v in model.state_dict().items()}
        device_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        priorities = port_priorities(2, 576, 32)
        metrics_jax, states, _ = jax_run
        for i, want_metrics in enumerate(metrics_jax):
            start = merge_train_state(_template(model, optimizer, i),
                                      states[i], paths)
            model.load_state_dict(start["model"])
            optimizer.load_state_dict(start["optimizer"])
            before = {k: v.clone() for k, v in start["model"].items()}
            metrics = step(device_batch, i, None, priorities)
            assert set(metrics) == set(want_metrics)
            for key, value in want_metrics.items():
                np.testing.assert_allclose(float(metrics[key]), value,
                                           rtol=KNOBS_LOSS_RTOL, err_msg=key)
            want = merge_train_state(_template(model, optimizer, i + 1),
                                     states[i + 1], paths)["model"]
            got = model.state_dict()
            moves = {name: (got[name] - before[name],
                            want[name] - before[name])
                     for name, p in model.named_parameters()
                     if p.requires_grad}
            for name, (port, jax_move) in moves.items():
                if name.startswith(("rpn.", "rcnn.")):
                    assert _relative(port, jax_move) <= HEAD_MOVE_RTOL, name
            assert _relative(
                torch.cat([m.flatten() for m, _ in moves.values()]),
                torch.cat([m.flatten() for _, m in moves.values()]),
            ) <= ALL_MOVES_RTOL
            stats = [k for k in got if k.endswith(("running_mean",
                                                   "running_var"))]
            assert stats and all(k in want for k in stats)
            for name in stats:
                assert _relative(got[name] - before[name],
                                 want[name] - before[name]) \
                    <= STATS_MOVE_RTOL, name
        got = buffers(model)
        initial = {k: v for k, v in initial.items() if k in got}
        moved = {n for n, b in buffers(model).items()
                 if not torch.equal(b, initial[n])}
        # every unit's statistics move: the frozen block1 (before
        # fine_tune_from), the trunk and the block4 tail
        assert moved == set(initial)
        assert any(".block1." in n for n in moved)
        assert any("base_network_tail" in n for n in moved)

    def test_remat_is_bitwise_and_updates_the_statistics_once(
            self, batch, variables):
        device_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        priorities = port_priorities(2, 576, 32)
        runs = []
        for remat in (False, True):
            model, _, step = port_step(
                knob_config(train_batch_norm=True, remat=remat), variables)
            bn = model.base_network.resnet_v1_50.block3.unit_1.conv1_bn
            calls = []
            bn.register_forward_hook(lambda *args: calls.append(None))
            metrics = step(device_batch, 0, None, priorities)
            runs.append((metrics, model.state_dict(), len(calls)))
        (m_off, s_off, calls_off), (m_on, s_on, calls_on) = runs
        # remat runs the unit's forward again in the backward pass ...
        assert (calls_off, calls_on) == (1, 2)
        # ... and changes no bit, the running statistics included.
        for key in m_off:
            assert torch.equal(m_off[key], m_on[key]), key
        assert s_off.keys() == s_on.keys()
        for key in s_off:
            assert torch.equal(s_off[key], s_on[key]), key
        initial = torch_state_from_flax(
            {"batch_stats": variables["batch_stats"]})
        key = ("base_network.resnet_v1_50.block3.unit_1.conv1_bn."
               "running_mean")
        assert not torch.equal(s_on[key], initial[key])

    def test_monitor_forward_uses_the_running_statistics(self, config, batch,
                                                         variables):
        model, _, _ = port_step(config, variables)
        images = torch.from_numpy(batch["image"])
        gt = torch.from_numpy(batch["gt_boxes"])
        before = buffers(model)
        model.train()
        preds = trainer.monitor_forward(model, {"image": images,
                                                "gt_boxes": gt})
        assert model.training
        for name, value in buffers(model).items():
            assert torch.equal(value, before[name]), name
        plain = load_flax_variables(FasterRCNN(knob_config()), variables)
        with torch.no_grad():
            want = plain.eval()(images, gt_boxes=gt)
        assert torch.equal(
            preds["classification_prediction"]["objects"],
            want["classification_prediction"]["objects"])


def _vgg_frcnn_config(**flags):
    config = knob_config(architecture="vgg_16", fine_tune_from="conv4",
                         **flags)
    return config


def _ssd_config(**flags):
    config = torch_config.get_model_config(
        torch_config.get_base_config("ssd"),
        Config({"model": {"network": {"num_classes": 3}}}))
    config.model.base_network.update(flags)
    return config


@pytest.mark.parametrize("family", ["vgg_16", "ssd"])
def test_vgg_backbones_ignore_both_flags(family, batch):
    """Neither flag changes VGG-16 (no batch norm, no remat): one port train
    step from equal weights gives equal losses and parameters."""
    make = _vgg_frcnn_config if family == "vgg_16" else _ssd_config
    cls = FasterRCNN if family == "vgg_16" else SSD
    size = (96, 128) if family == "vgg_16" else (300, 300)
    rng = np.random.RandomState(0)
    images = torch.from_numpy(
        (rng.rand(1, *size, 3) * 255).astype(np.float32))
    gt = torch.from_numpy(batch["gt_boxes"][:1])
    variables = init_variables(make(), seed=0)
    runs = []
    for flags in ({}, KNOBS):
        config = make(**flags)
        model = load_flax_variables(cls(config), variables)
        mask = training.build_trainable_mask(model, config.model)
        for name, p in model.named_parameters():
            p.requires_grad_(mask[name])
        optimizer, _ = training.get_optimizer(
            config.train, dict(model.named_parameters()), mask)
        step = trainer.make_train_step(model, optimizer)
        metrics = step({"image": images, "gt_boxes": gt}, 0,
                       torch.Generator().manual_seed(0))
        runs.append((metrics, model.state_dict()))
    (m_a, s_a), (m_b, s_b) = runs
    for key in m_a:
        assert torch.equal(m_a[key], m_b[key]), key
    for key in s_a:
        assert torch.equal(s_a[key], s_b[key]), key


# ---------------------------------------------------------- ignore_scope


def _template(model, optimizer, step=0):
    return {"step": step, "model": model.state_dict(),
            "optimizer": optimizer.state_dict()}


def test_ignore_scope_restores_what_jax_restores(tmp_path, config,
                                                 variables, jax_run):
    """A JAX train state after two steps, saved as msgpack by the JAX
    package, restored into a fresh state with ``ignore_scope: rcnn``."""
    JaxCheckpointManager(str(tmp_path)).save(jax_run[2], 2)
    template = jax_state(config, variables)
    want = JaxCheckpointManager(str(tmp_path)).restore_latest(
        template, ignore_scope="rcnn")

    model, optimizer, _ = port_step(config, variables)
    got = CheckpointManager(tmp_path).restore_latest(
        template=_template(model, optimizer), paths=flax_paths(model),
        ignore_scope="rcnn")
    assert got["step"] == int(want.step) == 2
    want_model = torch_state_from_flax({"params": want.params,
                                        "batch_stats": want.batch_stats})
    assert set(got["model"]) == set(want_model)
    for name, value in got["model"].items():
        assert torch.equal(value, want_model[name]), name
    # the optimizer's traces: the JAX merge's, by the weight bridge
    opt = serialization.to_state_dict(want.opt_state)
    traces = [node["trace"] for node in _dicts(opt) if "trace" in node]
    assert len(traces) == 1
    want_trace = torch_state_from_flax({"params": traces[0]})
    slots = got["optimizer"]["slots"]
    assert set(slots) == set(want_trace)
    for name, value in want_trace.items():
        assert torch.equal(slots[name]["trace"], value), name
    # the scope was skipped (the fresh values) and the rest restored
    saved = torch_state_from_flax({"params": jax_run[2].params})
    fresh = torch_state_from_flax({"params": variables["params"]})
    rcnn = [n for n in slots if n.startswith("rcnn.")]
    rest = [n for n in slots if not n.startswith("rcnn.")]
    assert rcnn and rest
    for name in rcnn:
        assert torch.equal(got["model"][name], fresh[name]), name
        assert not slots[name]["trace"].any(), name
    for name in rest:
        assert torch.equal(got["model"][name], saved[name]), name
        assert slots[name]["trace"].any(), name
    drop_checkpoints(tmp_path)


def _dicts(node):
    if isinstance(node, dict):
        yield node
        for value in node.values():
            yield from _dicts(value)


def _trained(config, variables, seed):
    """A model and optimizer whose weights and slots all differ from
    ``variables``' fresh ones, as after training."""
    model, optimizer, _ = port_step(config, variables)
    generator = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for value in model.state_dict().values():
            value.add_(torch.rand(value.shape, generator=generator))
        for slots in optimizer.slots.values():
            for value in slots.values():
                value.add_(torch.rand(value.shape, generator=generator))
    optimizer.count = 7
    return model, optimizer


def test_ignore_scope_on_a_port_checkpoint(tmp_path, variables):
    config = knob_config()
    trained, trained_opt = _trained(config, variables, seed=1)
    CheckpointManager(tmp_path).save(_template(trained, trained_opt, 7), 7)
    model, optimizer, _ = port_step(config, variables)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    got = CheckpointManager(tmp_path).restore_latest(
        template=_template(model, optimizer), paths=flax_paths(model),
        ignore_scope="rcnn")
    assert got["step"] == 7 and got["optimizer"]["count"] == 7
    saved = trained.state_dict()
    for name, value in got["model"].items():
        want = fresh[name] if name.startswith("rcnn.") else saved[name]
        assert torch.equal(value, want), name
    for name, slots in got["optimizer"]["slots"].items():
        want = (torch.zeros_like(slots["trace"]) if name.startswith("rcnn.")
                else trained_opt.slots[name]["trace"])
        assert torch.equal(slots["trace"], want), name
    # without the scope, everything comes back
    got = CheckpointManager(tmp_path).restore_latest(
        template=_template(model, optimizer), paths=flax_paths(model))
    for name, value in got["model"].items():
        assert torch.equal(value, saved[name]), name
    drop_checkpoints(tmp_path)


def test_a_shape_mismatch_keeps_the_template(variables):
    """A 2-class checkpoint restored into a 3-class model: the class-sized
    tensors (and their slots) keep the template, the rest is restored."""
    small = knob_config()
    small.model.network.num_classes = 2
    trained, trained_opt = _trained(small, init_variables(small, seed=2), 3)
    config = knob_config()
    model, optimizer, _ = port_step(config, variables)
    template = _template(model, optimizer)
    fresh = {k: v.clone() for k, v in template["model"].items()}
    got = merge_train_state(template, _template(trained, trained_opt, 3),
                            flax_paths(model))
    saved = trained.state_dict()
    mismatched = {k for k in fresh if saved[k].shape != fresh[k].shape}
    assert mismatched == {"rcnn.fc_classifier.weight",
                          "rcnn.fc_classifier.bias", "rcnn.fc_bbox.weight",
                          "rcnn.fc_bbox.bias"}
    for name, value in got["model"].items():
        want = fresh[name] if name in mismatched else saved[name]
        assert torch.equal(value, want), name
    for name in mismatched:
        assert not got["optimizer"]["slots"][name]["trace"].any()


# ------------------------------------------------------- tf_debug, trace


def _run_config(tmp_path, data_dir, get_config, weights=None, **train):
    train = {"job_dir": str(tmp_path / "jobs"), "run_name": "r",
             "batch_size": 1, "seed": 3, "learning_rate": {
                 "learning_rate": 1e-4}, **train}
    base_network = {"architecture": "resnet_v1_50"}
    if weights:
        base_network["weights"] = weights
    return get_config({
        "train": train,
        "dataset": {"dir": data_dir, "image_preprocessing": {
            "min_size": 64, "max_size": 64,
            "canvas_height": 64, "canvas_width": 64}},
        "model": {"type": "fasterrcnn", "network": {"num_classes": 2},
                  "base_network": base_network,
                  "rpn": {"proposals": {"pre_nms_top_n": 64,
                                        "post_nms_top_n": 16}}},
    })


def _port_config(overrides):
    return torch_config.get_model_config(
        torch_config.get_base_config("fasterrcnn"), Config(overrides))


def _jax_config(overrides, tmp_path):
    import yaml

    path = tmp_path / "jax.yml"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(overrides))))
    return jax_get_config([str(path)])


def test_tf_debug_raises_at_the_same_step_in_both_packages(tmp_path):
    """The first conv kernel of the trunk holds a NaN (through
    ``base_network.weights``): both ``train.run`` raise
    ``FloatingPointError`` at step 1, before any update or checkpoint."""
    data_dir = write_records(tmp_path)
    config = _run_config(tmp_path, data_dir, _port_config)
    flat = flatten_variables(init_variables(config, seed=0))
    key = "params/base_network/resnet_v1_50/conv1/kernel"
    flat[key] = flat[key].copy()
    flat[key].flat[0] = np.nan
    weights = str(tmp_path / "poisoned.npz")
    np.savez(weights, **flat)

    port = _run_config(tmp_path / "port", data_dir, _port_config, weights,
                       tf_debug=True)
    with pytest.raises(FloatingPointError, match="at step 1;") as raised:
        trainer.run(port, max_steps=2, device="cpu")
    assert "base_network/resnet_v1_50/conv1" in str(raised.value)
    assert not glob.glob(str(tmp_path / "port" / "jobs" / "r" / "ckpt" /
                             "*"))

    overrides = _run_config(tmp_path / "jax", data_dir, lambda o: o,
                            weights, tf_debug=True)
    steps = []
    original = jax_train.make_train_step

    def counting_step(*args, **kwargs):
        step = original(*args, **kwargs)

        def counted(*a, **k):
            steps.append(None)
            return step(*a, **k)
        return counted

    jax_train.make_train_step = counting_step
    try:
        with pytest.raises(FloatingPointError):
            jax_train.run(_jax_config(overrides, tmp_path), max_steps=2)
    finally:
        jax_train.make_train_step = original
        jax.config.update("jax_debug_nans", False)
    assert len(steps) == 1  # the JAX package raised in its first step


def test_full_trace_writes_a_profile(tmp_path):
    config = _run_config(tmp_path, write_records(tmp_path), _port_config,
                         full_trace=True)
    state = trainer.run(config, max_steps=6, device="cpu")
    assert state.step == 6
    traces = glob.glob(str(tmp_path / "jobs" / "r" / "profile" /
                           "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::convolution" in names
    drop_checkpoints(tmp_path)
