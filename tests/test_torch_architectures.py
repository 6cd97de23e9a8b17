"""The port's other Faster R-CNN backbones and head knobs against the JAX
package (CPU, float32).

Modules: the ResNet v2 trunk and tail, ResNet v1 with ``torchvision_compat``
(torchvision's stride convention, float and the int8 trunk), VGG-16 at its
Faster R-CNN endpoint and through its fc stack, the RCNN head with
``use_mean: False`` and RPNs with even kernels. Then small Faster R-CNNs
end to end against the JAX ``PredictorNetwork`` on ``resnet_v2_50``,
``vgg_16`` (with ``use_mean: False``) and ``resnet_v1_50`` with
``torchvision_compat``, and two ``vgg_16`` train steps against the JAX
``make_train_step``.

Weights are the flax modules' own random init, batch norms randomized,
carried across by ``utils/weights.py``. Tolerances: the float modules
agree to ``REL_TOL`` of their output's largest magnitude (float32 sums in
another order; measured below 2e-6); the int8 trunk with exact batch norms
and a single-tap root is bitwise equal (``tests/test_torch_int8.py``);
detections as in ``tests/test_torch_slice.py`` (labels and order equal,
boxes to 1e-2 px, probabilities to 1e-5); train steps as in
``tests/test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luminoth_tpu.models.base import BaseNetworkTail as JaxTail
from luminoth_tpu.models.base import TruncatedBaseNetwork as JaxTrunk
from luminoth_tpu.models.base.resnet import _plan_units as jax_plan_units
from luminoth_tpu.models.base.vgg import VGG16 as JaxVGG16
from luminoth_tpu.models.fasterrcnn.rcnn import RCNNHead as JaxRCNNHead
from luminoth_tpu.models.fasterrcnn.rpn import RPN as JaxRPN
from luminoth_tpu.train import TrainState, make_train_step as jax_step
from luminoth_tpu.utils import training as jax_training
from luminoth_tpu.utils.config import Config
from luminoth_tpu.utils.predicting import PredictorNetwork as JaxPredictor
from luminoth_tpu_torch import train as trainer
from luminoth_tpu_torch.models.base.base_network import (
    BaseNetworkTail,
    TruncatedBaseNetwork,
)
from luminoth_tpu_torch.models.base.resnet import (
    RESNET_BLOCK_DEFS,
    ResNet,
    _plan_units,
)
from luminoth_tpu_torch.models.base.vgg import VGG16
from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN
from luminoth_tpu_torch.models.fasterrcnn.rcnn import RCNNHead
from luminoth_tpu_torch.models.fasterrcnn.rpn import RPN
from luminoth_tpu_torch.utils import config as torch_config
from luminoth_tpu_torch.utils import predicting, training
from luminoth_tpu_torch.utils.weights import (
    flatten_variables,
    flax_variables_from_torch,
    init_variables,
    load_flax_variables,
    nest_variables,
    torch_state_from_flax,
)
from test_torch_backbone import assert_rel_close, randomize_bn, rpn_config
from test_torch_eval import rescaled_jax_variables
from test_torch_int8 import bn_statistics, single_tap
from test_torch_isolation import (  # noqa: F401
    default_threads,
    few_threads,
    jax_cache_isolation,
)
from test_torch_slice import BOX_ATOL, PROB_ATOL
from test_torch_train import (
    LOSS_RTOL,
    PARAM_ATOL,
    PARAM_RTOL,
    KeyedFasterRCNN,
    port_priorities,
)

REL_TOL = 1e-5
ODD = (70, 98)  # sides not multiples of 16: the SAME pads are exercised


def images(shape=ODD, batch=2, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(batch, *shape, 3) * 255).astype(np.float32)


def trunk_config(architecture, **extra):
    return Config({"architecture": architecture, "output_stride": 16,
                   "use_tail": True, **extra})


def block_outputs(trunk, x):
    """``{block name: NCHW output}`` of the port's ResNet on ``x``."""
    module = getattr(trunk, trunk.architecture)
    outputs, hooks = {}, []
    for name in module.block_names:
        last = list(getattr(module, name).values())[-1]
        hooks.append(last.register_forward_hook(
            lambda _m, _i, out, name=name: outputs.__setitem__(name, out)))
    try:
        with torch.inference_mode():
            trunk(x)
    finally:
        for hook in hooks:
            hook.remove()
    return outputs


def jax_trunk_case(cfg, shape=ODD, seed=1):
    x = images(shape)
    jax_trunk = JaxTrunk(cfg)
    variables = randomize_bn(
        jax_trunk.init(jax.random.PRNGKey(seed), jnp.asarray(x[:1])),
        np.random.RandomState(seed))
    return jax_trunk, variables, x


class TestResNet:
    @pytest.mark.parametrize("depth", [50, 101, 152])
    @pytest.mark.parametrize("output_stride", [None, 8, 16, 32])
    def test_stride_first_plan_matches_jax(self, depth, output_stride):
        defs = RESNET_BLOCK_DEFS[depth]
        want = jax_plan_units(defs, output_stride, stride_first=True)
        assert _plan_units(defs, output_stride, stride_first=True) == want
        # torchvision's stride sits on the first unit, one block later.
        if output_stride is None:
            assert [units[0][1] for _, units in want] == [1, 2, 2, 2]

    @pytest.mark.parametrize("architecture,compat", [
        ("resnet_v2_50", False), ("resnet_v1_50", True),
        ("resnet_v2_50", True),
    ])
    def test_trunk_endpoints_match_jax(self, architecture, compat):
        """Every block's output, not only the map: the shifted strides meet
        the output-stride bookkeeping one block later."""
        cfg = trunk_config(architecture, torchvision_compat=compat)
        jax_trunk, variables, x = jax_trunk_case(cfg)
        want_map, want = jax_trunk.apply(variables, jnp.asarray(x),
                                         return_endpoints=True)
        trunk = load_flax_variables(TruncatedBaseNetwork(cfg), variables)
        got = block_outputs(trunk.eval(), torch.from_numpy(x))
        assert list(got) == ["block1", "block2", "block3"]
        for name, value in got.items():
            assert_rel_close(value.permute(0, 2, 3, 1), want[name], REL_TOL)
        with torch.inference_mode():
            out = trunk(torch.from_numpy(x))
        assert out.shape == ((2, 5, 7, 1024) if compat else (2, 5, 6, 1024))
        assert_rel_close(out, want_map, REL_TOL)

    def test_v2_tail_matches_jax(self):
        cfg = trunk_config("resnet_v2_50")
        rng = np.random.RandomState(2)
        feats = rng.randn(3, 7, 7, 1024).astype(np.float32)
        jax_tail = JaxTail(cfg)
        variables = randomize_bn(
            jax_tail.init(jax.random.PRNGKey(2), jnp.asarray(feats)), rng)
        want = jax_tail.apply(variables, jnp.asarray(feats))
        tail = load_flax_variables(BaseNetworkTail(cfg, 1024), variables)
        assert "postnorm" not in str(flatten_variables(variables).keys())
        with torch.inference_mode():
            got = tail.eval()(torch.from_numpy(feats))
        assert got.shape == (3, 7, 7, 2048)
        assert_rel_close(got, want, REL_TOL)

    def test_v2_biases_and_root(self):
        """v2 carries slim's biases on the projection shortcut, conv3 and
        the root conv, and no root batch norm."""
        trunk = ResNet(depth=50, output_stride=16, version=2)
        names = set(trunk.state_dict())
        assert "conv1.bias" in names and not any(
            n.startswith("conv1_bn") for n in names)
        assert {"block1.unit_1.shortcut.bias", "block1.unit_1.conv3.bias",
                "block1.unit_1.preact.running_var"} <= names
        assert "block1.unit_2.shortcut.weight" not in names
        assert not any(n.endswith("conv3_bn.weight") for n in names)

    @pytest.mark.parametrize("flag", ["int8_trunk", "int8_tail"])
    def test_int8_flags_on_v2_build_the_float_modules(self, flag):
        """As in the JAX package, the int8 flags are silent on v2."""
        cfg = trunk_config("resnet_v2_50", **{flag: True})
        jax_trunk, variables, x = jax_trunk_case(cfg)
        want = jax_trunk.apply(variables, jnp.asarray(x))
        trunk = load_flax_variables(TruncatedBaseNetwork(cfg), variables)
        assert not trunk.int8
        with torch.inference_mode():
            got = trunk.eval()(torch.from_numpy(x))
        assert_rel_close(got, want, REL_TOL)
        tail = BaseNetworkTail(cfg, 1024)
        assert type(tail.resnet_v2_50).__name__ == "ResNetTail"

    def test_torchvision_compat_int8_trunk_equals_jax(self):
        """Exact batch norms and a single-tap root: every float operation
        is exact, so the int8 trunk is bitwise the JAX one."""
        rng = np.random.RandomState(4)
        cfg = trunk_config("resnet_v1_50", torchvision_compat=True,
                           int8_trunk=True)
        x = images(seed=4)
        variables = bn_statistics(
            JaxTrunk(cfg).init(jax.random.PRNGKey(2), x[:1]), rng, True)
        variables.pop("int8_stats", None)
        root = variables["params"]["resnet_v1_50"]["conv1"]
        root["kernel"] = single_tap(root["kernel"], rng)
        want = np.asarray(jax.jit(JaxTrunk(cfg).apply)(variables, x))
        trunk = load_flax_variables(TruncatedBaseNetwork(cfg), variables)
        assert trunk.int8
        with torch.inference_mode():
            got = trunk.eval()(torch.from_numpy(x))
        assert got.shape == (2, 5, 7, 1024)
        np.testing.assert_array_equal(got.numpy(), want)


class TestVGG:
    def test_frcnn_trunk_matches_jax(self):
        """``vgg_16`` stops at conv5/conv5_3 (stride 16), flax SAME pads."""
        cfg = trunk_config("vgg_16")
        jax_trunk, variables, x = jax_trunk_case(cfg)
        want = jax_trunk.apply(variables, jnp.asarray(x))
        trunk = load_flax_variables(TruncatedBaseNetwork(cfg), variables)
        assert not hasattr(trunk.vgg_16, "fc6")
        with torch.inference_mode():
            got = trunk.eval()(torch.from_numpy(x))
        assert got.shape == (2, 4, 6, 512)
        assert_rel_close(got, want, REL_TOL)
        tail = BaseNetworkTail(cfg, 512)
        feats = torch.rand(3, 7, 7, 512)
        assert tail(feats) is feats and tail.out_channels == 512

    @pytest.mark.parametrize("endpoint", ["conv3/conv3_2", "conv4/conv4_1"])
    def test_other_endpoints_match_jax(self, endpoint):
        cfg = trunk_config("vgg_16", endpoint=endpoint)
        jax_trunk, variables, x = jax_trunk_case(cfg, shape=(38, 50))
        want = jax_trunk.apply(variables, jnp.asarray(x))
        trunk = load_flax_variables(TruncatedBaseNetwork(cfg), variables)
        with torch.inference_mode():
            got = trunk.eval()(torch.from_numpy(x))
        assert_rel_close(got, want, REL_TOL)

    def test_unknown_endpoint_raises(self):
        with pytest.raises(ValueError, match="Unknown endpoint"):
            VGG16(truncated=False, endpoint="conv5/conv5_4")

    def test_full_fc_stack_matches_jax(self):
        """pool5, fc6 (7x7 VALID), fc7 and fc8 at 224x224."""
        x = images((224, 224), batch=1, seed=5)
        jax_vgg = JaxVGG16(truncated=False, num_classes=3)
        variables = jax.tree_util.tree_map(np.asarray, jax_vgg.init(
            jax.random.PRNGKey(5), jnp.asarray(x)))
        want, want_points = jax_vgg.apply(variables, jnp.asarray(x))
        vgg = VGG16(truncated=False, num_classes=3)
        load_flax_variables(vgg, variables)
        with torch.inference_mode():
            got, points = vgg(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert got.shape == (1, 3, 1, 1)
        assert set(points) == set(want_points)
        for name in ("conv5/conv5_3", "fc6", "fc7"):
            assert_rel_close(points[name].permute(0, 2, 3, 1),
                             want_points[name], REL_TOL)
        assert_rel_close(got.permute(0, 2, 3, 1), want, REL_TOL)


class TestHeads:
    def test_rcnn_without_mean_matches_jax(self):
        """``use_mean: False`` flattens NHWC features in (h, w, c) order,
        the row order of the flax kernel, also from a permuted tensor."""
        rng = np.random.RandomState(6)
        cfg = Config({"use_mean": False, "layer_sizes": [16],
                      "activation_function": "relu6"})
        feats = rng.randn(5, 3, 4, 8).astype(np.float32)
        jax_head = JaxRCNNHead(num_classes=3, config=cfg)
        variables = jax_head.init(jax.random.PRNGKey(6), jnp.asarray(feats))
        want = jax_head.apply(variables, jnp.asarray(feats))
        head = load_flax_variables(RCNNHead(3 * 4 * 8, 3, cfg), variables)
        # The tail hands over a permuted channels-last tensor.
        nchw = torch.from_numpy(feats).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        with torch.inference_mode():
            got = head.eval()(nchw.permute(0, 2, 3, 1))
        for g, w in zip(got, want):
            assert_rel_close(g, w, REL_TOL)

    @pytest.mark.parametrize("kernel", [[2, 2], [4, 3], [1, 1]])
    def test_rpn_kernel_shapes_match_jax(self, kernel):
        """flax SAME at stride 1: k - 1 in all, (k - 1) // 2 before."""
        rng = np.random.RandomState(7)
        cfg = rpn_config()
        cfg.kernel_shape = kernel
        fmap = rng.randn(2, 5, 7, 32).astype(np.float32)
        jax_rpn = JaxRPN(num_anchors=3, config=cfg)
        variables = jax_rpn.init(jax.random.PRNGKey(7), jnp.asarray(fmap))
        want = jax_rpn.apply(variables, jnp.asarray(fmap))
        rpn = load_flax_variables(RPN(32, 3, cfg), variables)
        with torch.inference_mode():
            got = rpn(torch.from_numpy(fmap))
        for key in want:
            assert_rel_close(got[key], want[key], REL_TOL)


# ------------------------------------------------------- end to end

CANVAS = (96, 128)
MODELS = {
    "resnet_v2_50": {"base_network": {"architecture": "resnet_v2_50"}},
    "vgg_16": {"base_network": {"architecture": "vgg_16",
                                "fine_tune_from": "conv3"},
               "rcnn": {"use_mean": False, "layer_sizes": [32],
                        "roi": {"pooled_width": 4, "pooled_height": 3}}},
    "resnet_v1_50_tv": {"base_network": {"architecture": "resnet_v1_50",
                                         "torchvision_compat": True}},
}


def model_config(name, **train):
    model = MODELS[name]
    overrides = {
        "train": {"clip_by_norm": True,
                  "learning_rate": {"learning_rate": 1e-3},
                  "optimizer": {"type": "momentum", "momentum": 0.9},
                  **train},
        "dataset": {"image_preprocessing": {
            "min_size": 96, "max_size": 128,
            "canvas_height": CANVAS[0], "canvas_width": CANVAS[1]}},
        "model": {
            "network": {"num_classes": 3},
            "base_network": model["base_network"],
            "rpn": {"proposals": {"pre_nms_top_n": 128,
                                  "post_nms_top_n": 32},
                    "target": {"minibatch_size": 64}},
            "rcnn": {**model.get("rcnn", {}),
                     "target": {"minibatch_size": 16},
                     "proposals": {"total_max_detections": 10,
                                   "class_max_detections": 8,
                                   "min_prob_threshold": 0.0}},
        },
    }
    return torch_config.get_model_config(
        torch_config.get_base_config("fasterrcnn"), Config(overrides))


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request):
    config = model_config(request.param)
    return request.param, config, rescaled_jax_variables(config)


def served_images():
    rng = np.random.RandomState(1)
    return [rng.randint(0, 256, (80, 100, 3)).astype(np.uint8),
            rng.randint(0, 256, (120, 90, 3)).astype(np.uint8)]


class TestFasterRCNN:
    def test_predictor_matches_jax(self, case):
        name, config, variables = case
        want = JaxPredictor(config, variables=variables, mesh=None)
        got = predicting.PredictorNetwork(config, variables, device="cpu")
        w = want.predict_batch(served_images(), pad_to=2)
        g = got.predict_batch(served_images(), pad_to=2)
        assert len(g) == len(w) == 2
        labels = set()
        for g_objs, w_objs in zip(g, w):
            assert len(g_objs) == len(w_objs) > 0
            assert [o["label"] for o in g_objs] == [o["label"] for o in w_objs]
            np.testing.assert_allclose(
                [o["bbox"] for o in g_objs], [o["bbox"] for o in w_objs],
                rtol=0, atol=BOX_ATOL)
            np.testing.assert_allclose(
                [o["prob"] for o in g_objs], [o["prob"] for o in w_objs],
                rtol=0, atol=PROB_ATOL)
            labels |= {o["label"] for o in g_objs}
        assert len(labels) > 1, name

    def test_init_and_export_keep_the_flax_layout(self, case):
        """``init_variables`` draws the JAX init's paths and shapes, and
        ``flax_variables_from_torch`` gives the loaded variables back;
        ``nest_variables`` nests them as the JAX tree."""
        _, config, variables = case
        want = flatten_variables(variables)
        drawn = flatten_variables(init_variables(config, seed=3))
        assert set(drawn) == set(want)
        for key, value in want.items():
            assert drawn[key].shape == value.shape, key
        model = load_flax_variables(FasterRCNN(config), variables)
        back = flax_variables_from_torch(model)
        assert set(back) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(back[key], value, err_msg=key)
        # Nested again, the tree the JAX model has (``block1/unit_1`` and
        # ``conv1/conv1_1`` stay one flax scope each).
        assert jax.tree_util.tree_structure(nest_variables(back)) == (
            jax.tree_util.tree_structure(variables))


# ------------------------------------------------------- vgg_16 training


@pytest.fixture(scope="module")
def vgg_train():
    config = model_config("vgg_16")
    variables = rescaled_jax_variables(config)
    rng = np.random.RandomState(0)
    batch = {"image": (rng.rand(2, *CANVAS, 3) * 255).astype(np.float32),
             "gt_boxes": np.full((2, 4, 5), -1, np.float32)}
    batch["gt_boxes"][0, :3] = [[10, 12, 60, 50, 0], [40, 30, 120, 90, 2],
                                [70, 5, 110, 40, 1]]
    batch["gt_boxes"][1, :2] = [[5, 5, 90, 80, 1], [60, 40, 125, 95, 0]]
    batch["gt_boxes"][..., :4][batch["gt_boxes"][..., 4] < 0] = 0

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
                       batch_stats=variables.get("batch_stats", {}))
    step = jax_step(model, tx, trainable_mask=mask, reg_fn=lambda p: (
        jax_training.l2_regularization_loss(p, coeffs)))
    device_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    results = []
    for _ in range(2):
        state, metrics = step(state, device_batch, jax.random.PRNGKey(9))
        results.append(({k: float(v) for k, v in metrics.items()},
                        jax.tree_util.tree_map(np.asarray, state.params)))
    return config, variables, batch, results


def test_vgg16_train_steps_match_jax(vgg_train, default_threads):
    """Torch's own thread count (``default_threads``): at 1, 2 and 4
    threads the gradient norm lands 1.1e-5 to 2.6e-5 off JAX's, past the
    step test's 1e-5."""
    config, variables, batch, results = vgg_train
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
    device_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    priorities = port_priorities(2, 576, 32)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i, (want_metrics, want_params) in enumerate(results):
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
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    moved = {n for n, p in model.named_parameters()
             if not torch.equal(p, before[n])}
    assert any("conv2" in n for n in frozen) and not moved & frozen
    assert any("conv3" in n for n in moved) and "rcnn.fc_0.weight" in moved
