"""The port's schedules, optimizers, trainable/decay masks, weight export
and checkpoints against the JAX package (CPU).

Schedules must equal optax's float32 values; three optimizer steps on the
same gradients must agree with the optax chain of
``luminoth_tpu.utils.training.get_optimizer`` to rtol 1e-6 / atol 1e-8;
masks and coefficients must be equal on the ResNet-50 Faster R-CNN's
parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from luminoth_tpu.models.fasterrcnn import FasterRCNN as JaxFasterRCNN
from luminoth_tpu.utils.checkpoint_io import load_params_npz, merge_flat_params
from luminoth_tpu.utils import training as jax_training
from luminoth_tpu.utils.config import Config
from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN
from luminoth_tpu_torch.utils import config as torch_config
from luminoth_tpu_torch.utils import training
from luminoth_tpu_torch.utils.checkpoint_io import CheckpointManager
from luminoth_tpu_torch.utils.weights import (
    flatten_variables,
    flax_paths,
    flax_variables_from_torch,
    init_variables,
    load_flax_variables,
    torch_state_from_flax,
)
from test_torch_isolation import few_threads  # noqa: F401

PARAM_RTOL, PARAM_ATOL = 1e-6, 1e-8

SCHEDULES = [
    {"learning_rate": 3e-4},
    {"decay_method": "none", "learning_rate": "1e-4"},
    {"decay_method": "piecewise_constant", "boundaries": [3, 7],
     "values": [0.1, 0.01, 0.001]},
    {"decay_method": "exponential_decay", "learning_rate": 0.1,
     "decay_steps": 4, "decay_rate": 0.5},
    {"decay_method": "exponential_decay", "learning_rate": 0.1,
     "decay_steps": 4, "decay_rate": 0.5, "staircase": True},
    {"decay_method": "polynomial_decay", "learning_rate": 0.1,
     "end_learning_rate": 0.003, "decay_steps": 6, "power": 2.0},
]


@pytest.mark.parametrize("lr_config", SCHEDULES)
def test_schedules_match_optax(lr_config):
    train_cfg = {"learning_rate": lr_config}
    want = jax_training.get_learning_rate(train_cfg)
    got = training.get_learning_rate(train_cfg)
    for step in range(12):
        assert np.float32(got(step)) == np.float32(want(step)), step


def test_invalid_schedule_and_optimizer_raise():
    with pytest.raises(ValueError):
        training.get_learning_rate({"learning_rate": {"decay_method": "x"}})
    with pytest.raises(ValueError):
        training.get_optimizer({"optimizer": {"type": "lamb"}}, {})


SHAPES = {"rpn/conv/kernel": (3, 4), "rpn/conv/bias": (4,),
          "rcnn/fc/kernel": (5, 2), "frozen/kernel": (2, 2)}


def nest(flat):
    tree = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def flat_of(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.update(flat_of(value, path))
        else:
            out[path] = np.asarray(value)
    return out


OPTIMIZERS = [
    {"type": "momentum", "momentum": 0.9},
    {"type": "sgd"},
    {"type": "gradient_descent"},
    {"type": "adam", "beta1": 0.8, "beta2": 0.99, "epsilon": 1e-3},
    # A large epsilon shows where it sits (inside the square root).
    {"type": "rmsprop", "decay": 0.8, "epsilon": 1e-2},
    {"type": "rmsprop", "decay": 0.9, "momentum": 0.5},
]


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("opt_config", OPTIMIZERS)
def test_optimizers_match_optax(rng, opt_config, clip):
    train_cfg = {
        "optimizer": dict(opt_config), "clip_by_norm": clip,
        "learning_rate": {"decay_method": "exponential_decay",
                          "learning_rate": 0.05, "decay_steps": 2,
                          "decay_rate": 0.7},
    }
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    trainable = {k: not k.startswith("frozen") for k in SHAPES}
    decay = {k: (0.01 if k.endswith("kernel") else 0.0) for k in SHAPES}
    # Gradient norms from ~1 to ~30: the clip at 10 both fires and not.
    # Frozen parameters get zero gradients, as make_train_step gives them.
    grads = [
        {k: (rng.randn(*s) * scale * trainable[k]).astype(np.float32)
         for k, s in SHAPES.items()}
        for scale in (0.3, 8.0, 1.0)
    ]

    tx, _ = jax_training.get_optimizer(
        Config(train_cfg), trainable_mask=nest(trainable),
        weight_decay=nest(decay),
    )
    jax_params = jax.tree_util.tree_map(jnp.asarray, nest(params))
    state = tx.init(jax_params)
    for g in grads:
        g = jax.tree_util.tree_map(jnp.asarray, nest(g))
        updates, state = tx.update(g, state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)

    torch_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    optimizer, _ = training.get_optimizer(
        Config(train_cfg), torch_params, trainable_mask=trainable,
        weight_decay=decay,
    )
    for step, g in enumerate(grads):
        optimizer.step({k: torch.from_numpy(v) for k, v in g.items()}, step)

    want = flat_of(jax_params)
    for key, value in torch_params.items():
        np.testing.assert_allclose(value.numpy(), want[key], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=key)
    np.testing.assert_array_equal(torch_params["frozen/kernel"].numpy(),
                                  params["frozen/kernel"])


def test_rmsprop_differs_from_torch_where_eps_sits(rng):
    p = torch.from_numpy(rng.randn(4).astype(np.float32))
    g = torch.from_numpy(rng.randn(4).astype(np.float32) * 1e-2)
    ours = {"w": p.clone()}
    optimizer, _ = training.get_optimizer(
        Config({"optimizer": {"type": "rmsprop", "epsilon": 1e-2},
                "learning_rate": {"learning_rate": 0.1}}), ours)
    optimizer.step({"w": g}, 0)
    theirs = p.clone().requires_grad_(True)
    torch_rms = torch.optim.RMSprop([theirs], lr=0.1, alpha=0.9, eps=1e-2)
    theirs.grad = g.clone()
    torch_rms.step()
    assert not torch.allclose(ours["w"], theirs.detach(), rtol=1e-4)


def test_clip_has_no_epsilon():
    g = {"w": torch.full((4,), 10.0)}  # global norm 20
    assert float(training.global_norm(g.values())) == 20.0
    p = {"w": torch.zeros(4)}
    optimizer, _ = training.get_optimizer(
        Config({"optimizer": {"type": "sgd"}, "clip_by_norm": True,
                "learning_rate": {"learning_rate": 1.0}}), p)
    assert float(optimizer.step(g, 0)) == 20.0  # the norm before the clip
    assert torch.equal(p["w"], torch.full((4,), -5.0))


@pytest.fixture(scope="module")
def r50():
    """(config, port model, JAX params) of a small ResNet-50 detector."""
    config = torch_config.get_model_config(
        torch_config.get_base_config("fasterrcnn"),
        Config({"model": {"network": {"num_classes": 3},
                          "base_network": {"architecture": "resnet_v1_50"}}}),
    )
    model = FasterRCNN(config)
    variables = JaxFasterRCNN(config).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    return config, model, jax.tree_util.tree_map(np.asarray, variables)


def paths_by_name(model):
    return {name: path[len("params/"):]
            for name, path in flax_paths(model).items()
            if path.startswith("params/")}


@pytest.mark.parametrize("base_network", [
    {},
    {"fine_tune_from": "block3/unit_2"},
    {"fine_tune_from": "resnet_v1_50/conv1"},
    {"fine_tune_from": "block3", "freeze_tail": True},
    {"fine_tune_from": None, "trainable": False},
    {"fine_tune_from": None},
])
def test_trainable_mask_matches_jax(r50, base_network):
    config, model, variables = r50
    model_config = Config(config.model.to_dict() if hasattr(
        config.model, "to_dict") else dict(config.model))
    model_config.base_network = Config(
        {**dict(config.model.base_network), **base_network})
    want = flat_of(jax_training.build_trainable_mask(
        variables["params"], model_config))
    got = training.build_trainable_mask(model, model_config)
    paths = paths_by_name(model)
    assert set(paths.values()) == set(want)
    for name, path in paths.items():
        assert got[name] == bool(want[path]), path
    assert 0 < sum(got.values()) <= len(got)


def test_invalid_fine_tune_from_raises(r50):
    config, model, _ = r50
    model_config = Config(dict(config.model))
    model_config.base_network = Config(
        {**dict(config.model.base_network), "fine_tune_from": "block9"})
    with pytest.raises(ValueError):
        training.build_trainable_mask(model, model_config)


def test_decay_coefficients_and_l2_match_jax(r50, rng):
    config, model, variables = r50
    want = flat_of(jax_training.build_weight_decay_coefficients(
        variables["params"], config.model))
    got = training.build_weight_decay_coefficients(model, config.model)
    paths = paths_by_name(model)
    for name, path in paths.items():
        assert got[name] == float(want[path]), path
    assert {got[n] for n in got} == {0.0, 0.0005}

    load_flax_variables(model, variables)
    jax_l2 = jax_training.l2_regularization_loss(
        variables["params"], jax_training.build_weight_decay_coefficients(
            variables["params"], config.model))
    port_l2 = training.l2_regularization_loss(
        dict(model.named_parameters()), got)
    np.testing.assert_allclose(float(port_l2), float(jax_l2), rtol=1e-5)


def test_torch_to_flax_round_trip(r50):
    config, model, variables = r50
    load_flax_variables(model, variables)
    flat = flax_variables_from_torch(model)
    assert set(flat) == set(flatten_variables(variables))
    for key, value in flatten_variables(variables).items():
        np.testing.assert_array_equal(flat[key], value, err_msg=key)
    state = torch_state_from_flax(flat)
    for key, value in model.state_dict().items():
        assert torch.equal(state[key], value), key


def test_exported_weights_drive_the_jax_model(tmp_path):
    """A port model's weights, exported to the flat flax layout (and an
    .npz), give the JAX model the port's forward."""
    config = torch_config.get_model_config(
        torch_config.get_base_config("fasterrcnn"),
        Config({"model": {
            "network": {"num_classes": 3},
            "base_network": {"architecture": "resnet_v1_50"},
            "rpn": {"proposals": {"pre_nms_top_n": 64,
                                  "post_nms_top_n": 16}},
        }}),
    )
    model = load_flax_variables(FasterRCNN(config),
                                init_variables(config, seed=5)).eval()
    path = tmp_path / "weights.npz"
    np.savez(path, **flax_variables_from_torch(model))
    # Read back the JAX package's way: flat paths merged into the model's
    # variable tree (whose scope names hold "/", e.g. "block1/unit_1").
    flat = load_params_npz(str(path))
    template = JaxFasterRCNN(config).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))
    variables = {}
    for collection, tree in template.items():
        variables[collection], loaded = merge_flat_params(
            tree, {k[len(collection) + 1:]: v for k, v in flat.items()
                   if k.startswith(collection + "/")})
        assert loaded == len(jax.tree_util.tree_leaves(tree))
    images = (np.random.RandomState(2).rand(1, 64, 96, 3) * 255).astype(
        np.float32)
    want = JaxFasterRCNN(config).apply(variables, jnp.asarray(images))
    with torch.inference_mode():
        got = model(torch.from_numpy(images))
    rpn_want, rpn_got = want["rpn_prediction"], got["rpn_prediction"]
    np.testing.assert_allclose(rpn_got["rpn_cls_prob"].numpy(),
                               np.asarray(rpn_want["rpn_cls_prob"]),
                               atol=1e-5)
    np.testing.assert_array_equal(rpn_got["proposals_valid"].numpy(),
                                  np.asarray(rpn_want["proposals_valid"]))
    np.testing.assert_allclose(rpn_got["proposals"].numpy(),
                               np.asarray(rpn_want["proposals"]), atol=1e-2)


class TestCheckpointManager:
    def test_save_restore_and_rotate(self, tmp_path):
        manager = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
        assert manager.restore_latest() is None
        for step in (1, 2, 3):
            manager.save({"step": step, "w": torch.full((2,), float(step)),
                          "nested": {"count": step}}, step)
        assert manager.all_steps() == [2, 3]
        restored = manager.restore_latest()
        assert restored["step"] == 3 and restored["nested"]["count"] == 3
        assert torch.equal(restored["w"], torch.full((2,), 3.0))

    def test_unreadable_newest_falls_back(self, tmp_path):
        manager = CheckpointManager(tmp_path, max_to_keep=3)
        manager.save({"step": 1}, 1)
        manager.save({"step": 2}, 2)
        (tmp_path / "ckpt_step_2.pt").write_bytes(b"truncated")
        assert manager.restore_latest()["step"] == 1
