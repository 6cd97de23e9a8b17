"""Port's ResNet v1 trunk and tail, RPN and RCNN heads, and weight bridge,
against the JAX package on CPU in float32.

Weights are the flax modules' own random init, with batch-norm statistics
and affine randomized so the bridge's BN mapping is exercised, carried
across by ``luminoth_tpu_torch.utils.weights``. Tolerances are relative to
the output's largest magnitude: float32 convolutions summed in another
order agree to ~1e-6 of scale (observed: 1.4e-6 through ResNet-50 block3
and 1e-6 through block4; PARITY.md states ~5e-4 abs on ~1e2 activations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luminoth_tpu.models.base import BaseNetworkTail as JaxTail
from luminoth_tpu.models.base import TruncatedBaseNetwork as JaxTrunk
from luminoth_tpu.models.base.resnet import _plan_units as jax_plan_units
from luminoth_tpu.models.fasterrcnn.rcnn import RCNNHead as JaxRCNNHead
from luminoth_tpu.models.fasterrcnn.rpn import RPN as JaxRPN
from luminoth_tpu.utils.checkpoint_io import flatten_params
from luminoth_tpu.utils.config import Config
from luminoth_tpu_torch.models.base.base_network import (
    BaseNetworkTail,
    TruncatedBaseNetwork,
)
from luminoth_tpu_torch.models.base.resnet import (
    RESNET_BLOCK_DEFS,
    _plan_units,
)
from luminoth_tpu_torch.models.fasterrcnn.rcnn import RCNNHead
from luminoth_tpu_torch.models.fasterrcnn.rpn import RPN
from luminoth_tpu_torch.utils import weights
from test_torch_isolation import few_threads  # noqa: F401

REL_TOL = 1e-5


def randomize_bn(variables, rng):
    """Random BN scale/bias/mean/var in a flax variable tree (numpy)."""
    def leaf(path, value):
        names = [getattr(p, "key", str(p)) for p in path]
        value = np.asarray(value)
        if "BatchNorm" not in names:
            return value
        if names[-1] in ("scale", "var"):
            return rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        return rng.normal(0, 0.2, value.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def assert_rel_close(got, want, rel=REL_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max(), scale
    )


def base_config(**extra):
    return Config({
        "architecture": "resnet_v1_50", "output_stride": 16,
        "use_tail": True, **extra,
    })


class TestResNet:
    @pytest.mark.parametrize("depth", [50, 101, 152])
    @pytest.mark.parametrize("output_stride", [None, 8, 16])
    def test_plan_units_match_jax(self, depth, output_stride):
        defs = RESNET_BLOCK_DEFS[depth]
        assert _plan_units(defs, output_stride) == jax_plan_units(
            defs, output_stride
        )

    # bf16: both round every layer's output to bf16, at different points
    # (flax casts params per op, cuDNN/oneDNN fuse differently); observed
    # max 1.4e-2 of scale (rms 0.9e-2) through ResNet-50 block3.
    @pytest.mark.parametrize("dtype,rel", [
        ("float32", REL_TOL), ("bfloat16", 3e-2),
    ])
    def test_trunk_matches_jax(self, rng, dtype, rel):
        cfg = base_config()
        images = (rng.rand(2, 70, 98, 3) * 255).astype(np.float32)
        jax_trunk = JaxTrunk(cfg, dtype=getattr(jnp, dtype))
        variables = randomize_bn(
            jax_trunk.init(jax.random.PRNGKey(1), jnp.asarray(images[:1])), rng
        )
        want = jax_trunk.apply(variables, jnp.asarray(images))

        trunk = weights.load_flax_variables(
            TruncatedBaseNetwork(cfg, dtype=getattr(torch, dtype)), variables
        )
        with torch.inference_mode():
            got = trunk(torch.from_numpy(images))
        assert got.shape == (2, 5, 6, 1024)  # odd sizes: conv2d_same pads
        assert got.dtype == getattr(torch, dtype)
        assert_rel_close(got.float(), np.asarray(want, np.float32), rel)

    def test_tail_matches_jax(self, rng):
        cfg = base_config()
        feats = np.maximum(rng.randn(3, 7, 7, 1024), 0).astype(np.float32)
        jax_tail = JaxTail(cfg)
        variables = randomize_bn(
            jax_tail.init(jax.random.PRNGKey(2), jnp.asarray(feats)), rng
        )
        want = jax_tail.apply(variables, jnp.asarray(feats))
        tail = weights.load_flax_variables(BaseNetworkTail(cfg, 1024), variables)
        with torch.inference_mode():
            got = tail(torch.from_numpy(feats))
        assert_rel_close(got, want)

    @pytest.mark.parametrize("architecture", [
        "resnet_v2_50", "vgg_16", "truncated_vgg_16",
    ])
    def test_unported_architectures_raise(self, architecture):
        """These architectures are ported now (held against JAX in
        ``tests/test_torch_architectures.py``): they build, with their
        flax scope and map depth, and an unknown one still raises."""
        trunk = TruncatedBaseNetwork(base_config(architecture=architecture))
        scope = "resnet_v2_50" if architecture.startswith("resnet") else (
            "vgg_16")
        assert trunk.architecture == scope
        assert trunk.out_channels == (1024 if scope == "resnet_v2_50"
                                      else 512)
        with torch.inference_mode():
            out = trunk.eval()(torch.rand(1, 64, 80, 3) * 255)
        assert out.shape == (1, 4, 5, trunk.out_channels)
        with pytest.raises(ValueError, match="Invalid architecture"):
            TruncatedBaseNetwork(base_config(architecture="resnet_v3_50"))

    @pytest.mark.parametrize("flag", ["torchvision_compat", "int8_trunk"])
    def test_unported_profiles_raise(self, flag):
        """``torchvision_compat`` is ported (torchvision's strides); the
        int8 trunk is ResNet v1 only, and on v2 the flag builds the float
        trunk, as in the JAX package."""
        architecture = "resnet_v2_50" if flag == "int8_trunk" else (
            "resnet_v1_50")
        trunk = TruncatedBaseNetwork(base_config(architecture=architecture,
                                                 **{flag: True}))
        module = getattr(trunk, architecture)
        assert not trunk.int8
        assert module.stride_first == (flag == "torchvision_compat")
        assert type(module).__name__ == "ResNet"


def rpn_config():
    return Config({
        "activation_function": "relu6", "num_channels": 64,
        "kernel_shape": [3, 3],
        "rpn_initializer": {"type": "random_normal_initializer",
                            "stddev": 0.05},
        "cls_initializer": {"type": "random_normal_initializer",
                            "stddev": 0.05},
        "bbox_initializer": {"type": "random_normal_initializer",
                             "stddev": 0.01},
    })


class TestHeads:
    def test_rpn_matches_jax(self, rng):
        fm = rng.randn(2, 6, 8, 32).astype(np.float32)
        jax_rpn = JaxRPN(12, rpn_config())
        variables = jax_rpn.init(jax.random.PRNGKey(3), jnp.asarray(fm))
        want = jax_rpn.apply(variables, jnp.asarray(fm))
        rpn = weights.load_flax_variables(RPN(32, 12, rpn_config()), variables)
        with torch.inference_mode():
            got = rpn(torch.from_numpy(fm))
        for key in ("rpn_cls_score", "rpn_cls_prob", "rpn_bbox_pred"):
            np.testing.assert_allclose(
                got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-6
            )

    @pytest.mark.parametrize("layer_sizes", [[], [32]])
    def test_rcnn_matches_jax(self, rng, layer_sizes):
        cfg = Config({
            "layer_sizes": layer_sizes, "activation_function": "relu6",
            "use_mean": True,
            "rcnn_initializer": {"type": "variance_scaling_initializer",
                                 "factor": 1.0, "uniform": True,
                                 "mode": "FAN_AVG"},
            "cls_initializer": {"type": "random_normal_initializer",
                                "stddev": 0.1},
            "bbox_initializer": {"type": "random_normal_initializer",
                                 "stddev": 0.01},
        })
        feats = np.maximum(rng.randn(5, 4, 4, 64), 0).astype(np.float32)
        jax_head = JaxRCNNHead(3, cfg)
        variables = jax_head.init(jax.random.PRNGKey(4), jnp.asarray(feats))
        want = jax_head.apply(variables, jnp.asarray(feats))
        head = weights.load_flax_variables(RCNNHead(64, 3, cfg), variables)
        with torch.inference_mode():
            got = head(torch.from_numpy(feats))
        for g, w in zip(got, want):
            np.testing.assert_allclose(
                g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6
            )


class TestBridge:
    def _variables(self):
        return JaxRPN(12, rpn_config()).init(
            jax.random.PRNGKey(5), jnp.zeros((1, 6, 8, 32))
        )

    def test_layouts(self):
        variables = self._variables()
        state = weights.torch_state_from_flax(variables)
        kernel = np.asarray(variables["params"]["conv"]["kernel"])
        np.testing.assert_array_equal(
            state["conv.weight"].numpy(), kernel.transpose(3, 2, 0, 1)
        )
        assert weights.torch_key(
            "batch_stats/a/unit_1/conv1_bn/BatchNorm/var"
        ) == "a.unit_1.conv1_bn.running_var"
        assert weights.torch_key("params/rcnn/fc_0/kernel") == "rcnn.fc_0.weight"

    def test_flat_npz_loads_like_nested(self, tmp_path):
        variables = self._variables()
        path = tmp_path / "rpn.npz"
        np.savez(path, **flatten_params(jax.device_get(variables)))
        nested = weights.torch_state_from_flax(variables)
        flat = weights.torch_state_from_flax(str(path))
        assert set(nested) == set(flat)
        for key in nested:
            np.testing.assert_array_equal(nested[key].numpy(), flat[key].numpy())

    def test_missing_key_raises(self):
        variables = jax.device_get(self._variables())
        del variables["params"]["cls_conv"]["bias"]
        with pytest.raises(KeyError, match="missing"):
            weights.load_flax_variables(RPN(32, 12, rpn_config()), variables)

    def test_extra_key_raises(self):
        variables = jax.device_get(self._variables())
        variables["params"]["extra"] = {"kernel": np.zeros((1, 1, 2, 2))}
        with pytest.raises(KeyError, match="left over"):
            weights.load_flax_variables(RPN(32, 12, rpn_config()), variables)

    def test_unknown_leaf_raises(self):
        with pytest.raises(KeyError):
            weights.torch_state_from_flax(
                {"params": {"conv": {"weird": np.zeros(3)}}}
            )

    def test_shape_mismatch_raises(self):
        variables = jax.device_get(self._variables())
        variables["params"]["conv"]["bias"] = np.zeros(3, np.float32)
        with pytest.raises(RuntimeError):
            weights.load_flax_variables(RPN(32, 12, rpn_config()), variables)
