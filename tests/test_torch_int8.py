"""The port's int8 serving profile against the JAX package (CPU).

The int8 twins (``models/base/quantized_tail.py``,
``models/ssd/quantized_extractor.py``), the ``int8_stats`` weight bridge,
the Faster R-CNN ``fast`` profile's calibration and detections through
``PredictorNetwork``, and the flags' float path in training
(``tests/test_torch_int8_serve.py`` serves SSD's ``fast`` profile). The JAX references run under ``jax.jit``, as the
JAX predictor runs them: XLA folds their ``/ 127`` into a product with the
reciprocal and their epilogues into fused multiply-adds, and the port
computes the same operations.

Tolerances, and why:
* int32 accumulators, int8 codes, ranges and the int8 layers' outputs:
  bitwise equal given the same inputs and the same folded weights.
* Folded weights: XLA computes ``γ/σ`` as ``γ·rsqrt(σ²+ε)`` with its own
  reciprocal square root, up to one unit in the last place (ulp) off the
  correctly rounded quotient. The bitwise module cases use batch norms
  with ``σ²+ε = 4``, where both are exact; with random statistics the
  folded kernel is within 2 ulp (``FOLD_RTOL``) and the twins' outputs
  within ``MODULE_RTOL`` of their largest magnitude.
* A float layer before an int8 one (the Faster R-CNN trunk before the
  tail, SSD's conv1/conv2, the ResNet root conv) sums in another order
  than XLA's; its last-ulp differences flip a few int8 codes, whose effect
  grows through the int8 layers. The end-to-end cases with such a layer
  state measured bounds; the SSD cases whose float stage is exact
  (single-tap power-of-two kernels, so every sum is exact in any order)
  are held bitwise, calibrated scales included.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luminoth_tpu.models.base import quantized_tail as jq
from luminoth_tpu.models.base.base_network import (
    TruncatedBaseNetwork as JaxTrunk,
)
from luminoth_tpu.models.ssd.feature_extractor import (
    SSDFeatureExtractor as JaxExtractor,
)
from luminoth_tpu.utils.config import Config
from luminoth_tpu.utils.predicting import PredictorNetwork as JaxPredictor
from luminoth_tpu_torch import train as trainer
from luminoth_tpu_torch.models.base import quantized_tail as pq
from luminoth_tpu_torch.models.base.base_network import TruncatedBaseNetwork
from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN
from luminoth_tpu_torch.models.ssd.feature_extractor import (
    SSDFeatureExtractor,
)
from luminoth_tpu_torch.utils import config as torch_config
from luminoth_tpu_torch.utils import predicting
from luminoth_tpu_torch.utils.serving import apply_serving_profile
from luminoth_tpu_torch.utils.weights import (
    flatten_variables,
    flax_paths,
    flax_variables_from_torch,
    init_variables,
    load_flax_variables,
)
from test_torch_eval import CONFIG, rescaled_jax_variables
from test_torch_isolation import (  # noqa: F401
    few_threads,
    jax_cache_isolation,
    lumi_home_isolation,
)
from test_torch_train import TestRun as _TrainRun  # not collected here
from test_torch_train import write_records

FOLD_RTOL = 2 * 2.0 ** -23  # folded kernel, random batch norm: 2 ulp
# Twins with random batch norms, of max |output| (measured: a unit
# 1.1e-7, the R50 tail over 6 ROIs 1.0e-2); SSD's int8 maps after a random
# float stage (measured 3.4e-2).
MODULE_RTOL, SSD_MAP_RTOL = 3e-2, 0.1
# Faster R-CNN `fast` end to end (int8 tail after the float trunk):
# calibrated maxima relative (measured 2.2e-3), detections' boxes in px
# (measured 0.015) and probabilities (measured 1.1e-3).
FRCNN_SCALE_RTOL, FRCNN_BOX_ATOL, FRCNN_PROB_ATOL = 1e-2, 0.1, 5e-3
BOX_ATOL = 1e-3  # px, detections of the exact-float-stage SSD
PROB_ATOL = 1e-4 + 1e-5  # the predictors round probabilities to 4 places
EXACT_VAR = np.float32(4.0) - np.float32(1e-5)  # σ² + ε = 4 exactly


def bn_statistics(variables, rng, exact):
    """Random batch-norm affine and means in a flax variable tree; the
    variance random in [0.5, 1.5], or ``EXACT_VAR`` when ``exact``."""
    def leaf(path, value):
        names = [getattr(p, "key", str(p)) for p in path]
        value = np.asarray(value)
        if "BatchNorm" not in names:
            return value
        if names[-1] == "var":
            return (np.full(value.shape, EXACT_VAR, np.float32) if exact
                    else rng.uniform(0.5, 1.5, value.shape).astype(
                        np.float32))
        if names[-1] == "scale":
            return rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        return rng.normal(0, 0.2, value.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def single_tap(kernel, rng):
    """An HWIO kernel of ``kernel``'s shape whose output channel o reads
    input channel o mod C at the centre tap, times 0.5 or 1: its conv is
    exact in any summation order."""
    kh, kw, cin, cout = kernel.shape
    out = np.zeros(kernel.shape, np.float32)
    out[kh // 2, kw // 2, np.arange(cout) % cin, np.arange(cout)] = (
        rng.choice([0.5, 1.0], cout))
    return out


def int8_stats(variables):
    """Flat ``int8_stats/...`` float32 scalars of nested or flat
    variables."""
    return {k: np.float32(v) for k, v in flatten_variables(
        jax.tree_util.tree_map(np.asarray, variables)).items()
        if k.startswith("int8_stats/")}


def port_stats(model):
    return {k: np.float32(v) for k, v in
            flax_variables_from_torch(model).items()
            if k.startswith("int8_stats/")}


def nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------ primitives


class TestPrimitives:
    def test_per_tensor_codes_and_scale_equal_jax(self):
        x = (np.random.RandomState(0).randn(4, 9, 11, 64) * 30).astype(
            np.float32)
        q, scale = jax.jit(jq.quantize_per_tensor)(x)
        got_q, got_r = pq.quantize_per_tensor(torch.from_numpy(x))
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(q))
        assert got_q.dtype == torch.int8
        assert np.float32(got_r * pq.INV_127) == np.float32(scale)

    def test_half_ties_round_to_even(self):
        """Codes at exact .5 ties round half to even, in both packages:
        a maximum of 15.875 gives the scale 0.125 exactly."""
        ties = np.arange(-126, 126, dtype=np.float32) + np.float32(0.5)
        x = np.concatenate([ties * np.float32(0.125), [15.875]]).astype(
            np.float32)
        got_q, got_r = pq.quantize_per_tensor(torch.from_numpy(x))
        assert np.float32(got_r * pq.INV_127) == np.float32(0.125)
        want = np.concatenate([np.round(ties), [127]])  # numpy: half even
        np.testing.assert_array_equal(got_q.numpy(), want)
        np.testing.assert_array_equal(
            np.asarray(jax.jit(jq.quantize_per_tensor)(x)[0]), want)
        assert set(np.abs(got_q.numpy()[:-1]) % 2) == {0}

    def test_per_channel_weights_equal_jax(self):
        w = (np.random.RandomState(1).randn(3, 3, 64, 96) * 0.05).astype(
            np.float32)
        w[..., 0] = 0  # an all-zero channel: the 1e-8 floor
        q, scales = jax.jit(jq.quantize_weight_per_channel)(w)
        got_q, got_r = pq.quantize_weight_per_channel(
            torch.from_numpy(w).permute(3, 2, 0, 1))
        np.testing.assert_array_equal(
            got_q.permute(2, 3, 1, 0).numpy(), np.asarray(q))
        np.testing.assert_array_equal(
            (got_r * pq.INV_127).numpy(), np.asarray(scales))

    @pytest.mark.parametrize("exact", [True, False])
    def test_fold_bn_matches_jax(self, exact):
        rng = np.random.RandomState(2)
        c = 4096
        kernel = rng.randn(1, 1, 16, c).astype(np.float32)
        gamma, beta, mean = (rng.uniform(0.5, 1.5, c), rng.normal(0, .2, c),
                             rng.normal(0, .2, c))
        var = (np.full(c, EXACT_VAR) if exact else rng.uniform(0.5, 1.5, c))
        args = [a.astype(np.float32) for a in (gamma, beta, mean, var)]
        want_k, want_b = map(np.asarray, jax.jit(jq.fold_bn)(kernel, *args))
        got_k, got_b = pq.fold_bn(torch.from_numpy(kernel).permute(3, 2, 0, 1),
                                  *map(torch.from_numpy, args))
        got_k = got_k.permute(2, 3, 1, 0).numpy()
        if exact:
            np.testing.assert_array_equal(got_k, want_k)
            np.testing.assert_array_equal(got_b.numpy(), want_b)
        else:
            np.testing.assert_allclose(got_k, want_k, rtol=FOLD_RTOL, atol=0)
            np.testing.assert_allclose(got_b.numpy(), want_b, rtol=0,
                                       atol=FOLD_RTOL * np.abs(want_b).max())


# ----------------------------------------------------------------- convs


def int8_inputs(rng, shape, cout, k):
    x = rng.randint(-127, 128, shape).astype(np.int8)
    w = rng.randint(-127, 128, (k, k, shape[-1], cout)).astype(np.int8)
    w_ranges = rng.uniform(0.1, 2.0, cout).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    return x, np.float32(3.7), w, w_ranges, bias


def port_weights(w):
    return pq.weight_matrix(torch.from_numpy(w).permute(3, 2, 0, 1))


CONV_CASES = [
    (padding, stride, rate, size)
    for padding in ("conv2d_same", "same", "valid")
    for stride in (1, 2)
    for rate in (1, 2, 6)
    for size in ((9, 9), (14, 12))
    if padding != "valid" or 3 + 2 * (rate - 1) <= min(size)
]


class TestConvs:
    @pytest.mark.parametrize("padding,stride,rate,size", CONV_CASES)
    def test_conv3x3_equals_jax(self, padding, stride, rate, size):
        """The im2col accumulators equal XLA's int8 convolution exactly;
        the outputs equal the JAX ``_int8_conv3x3``'s bitwise."""
        rng = np.random.RandomState(rate * 100 + stride * 10 + size[1])
        x, x_r, w, w_r, bias = int8_inputs(rng, (2,) + size + (16,), 24, 3)
        kernel_eff = 3 + 2 * (rate - 1)
        ph0, ph1, _ = jq._conv_pads(size[0], kernel_eff, stride, padding)
        pw0, pw1, _ = jq._conv_pads(size[1], kernel_eff, stride, padding)
        want_acc = np.asarray(jax.lax.conv_general_dilated(
            jnp.pad(x, ((0, 0), (ph0, ph1), (pw0, pw1), (0, 0))), w,
            (stride, stride), "VALID", rhs_dilation=(rate, rate),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32))
        rows, (n, oh, ow) = pq.im2col3x3(torch.from_numpy(x), stride, rate,
                                         padding)
        acc = pq.int8_mm(rows, port_weights(w))
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.view(n, oh, ow, -1).numpy(),
                                      want_acc)

        # The JAX twin takes scales; XLA folds the two 1/127 of a traced
        # graph (as in the model), so they are made inside the jit.
        def jax_conv(x, x_r, w, w_r, bias):
            return jq._int8_conv3x3(x, x_r / 127.0, w, w_r / 127.0, bias,
                                    stride=stride, rate=rate,
                                    padding=padding)

        want = np.asarray(jax.jit(jax_conv)(x, x_r, w, w_r, bias))
        got = pq._int8_conv3x3(torch.from_numpy(x), torch.tensor(x_r),
                               port_weights(w), torch.from_numpy(w_r),
                               torch.from_numpy(bias), stride=stride,
                               rate=rate, padding=padding)
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("rows", [1, 16, 17, 40])
    def test_conv1x1_equals_jax(self, rows):
        """Fewer rows than ``MIN_ROWS`` go through the zero-padded
        product; accumulators and outputs equal JAX's."""
        rng = np.random.RandomState(rows)
        x, x_r, w, w_r, bias = int8_inputs(rng, (1, 1, rows, 32), 40, 1)
        want_acc = np.asarray(jax.lax.conv_general_dilated(
            x, w, (1, 1), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32))
        acc = pq.int8_mm(torch.from_numpy(x).reshape(rows, 32),
                         port_weights(w))
        np.testing.assert_array_equal(acc.view(1, 1, rows, -1).numpy(),
                                      want_acc)

        def jax_mm(x, x_r, w, w_r, bias):
            return jq._int8_matmul_1x1(x, x_r / 127.0, w, w_r / 127.0, bias)

        want = np.asarray(jax.jit(jax_mm)(x, x_r, w, w_r, bias))
        got = pq._int8_matmul_1x1(torch.from_numpy(x), torch.tensor(x_r),
                                  port_weights(w), torch.from_numpy(w_r),
                                  torch.from_numpy(bias))
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------- modules


def calibrate_jax(module, variables, x):
    """The JAX twin's calibrating forward: ``(output, int8_stats)``."""
    out, updated = jax.jit(functools.partial(
        module.apply, mutable=["int8_stats"]))(variables, x)
    return out, updated["int8_stats"]


class TestBottleneck:
    @pytest.mark.parametrize("exact", [True, False])
    @pytest.mark.parametrize("depth_in,stride", [
        (64, 1), (64, 2), (32, 1), (32, 2),  # identity, projection
    ])
    def test_unit_matches_jax(self, depth_in, stride, exact):
        rng = np.random.RandomState(depth_in + stride)
        x = np.maximum(rng.randn(2, 9, 10, depth_in), 0).astype(np.float32)
        jax_unit = jq.Int8BottleneckV1(depth=64, depth_bottleneck=16,
                                       stride=stride)
        variables = bn_statistics(
            jax_unit.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng, exact)
        want = np.asarray(jax.jit(jax_unit.apply)(variables, x))
        unit = load_flax_variables(
            pq.Int8BottleneckV1(depth_in, 64, 16, stride).eval(), variables)
        with torch.inference_mode():
            got = unit.int8_forward(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (2, -(-9 // stride),
                                           -(-10 // stride), 64)
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=MODULE_RTOL * np.abs(want).max())


def tail_case(exact, static):
    rng = np.random.RandomState(3)
    x = np.maximum(rng.randn(6, 7, 7, 256) * 2, 0).astype(np.float32)
    jax_tail = jq.Int8ResNetTail(depth=50, static_scales=static)
    variables = bn_statistics(
        jq.Int8ResNetTail(depth=50).init(jax.random.PRNGKey(1), x), rng,
        exact)
    tail = load_flax_variables(
        pq.Int8ResNetTail(50, 256, static_scales=static).eval(), variables)
    return jax_tail, variables, tail, x


class TestTail:
    @pytest.mark.parametrize("exact", [True, False])
    def test_dynamic_matches_jax(self, exact):
        jax_tail, variables, tail, x = tail_case(exact, static=False)
        want = np.asarray(jax.jit(jax_tail.apply)(variables, x))
        with torch.inference_mode():
            got = nhwc(tail(torch.from_numpy(x).permute(0, 3, 1, 2)))
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=MODULE_RTOL * np.abs(want).max())

    def test_static_calibrates_and_serves_like_jax(self):
        """Calibration outputs and maxima equal JAX's; static serving on a
        new input equals JAX's with those maxima."""
        jax_tail, variables, tail, x = tail_case(exact=True, static=True)
        want, stats = calibrate_jax(jax_tail, variables, x)
        nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
        with torch.inference_mode(), pq.calibrating(tail):
            got = nhwc(tail(nchw))
        np.testing.assert_array_equal(got, want)
        want_stats = int8_stats({"int8_stats": stats})
        assert len(want_stats) == 9  # 3 units x 3 quant points
        assert port_stats(tail) == want_stats

        x2 = x * np.float32(0.7)
        want2 = np.asarray(jax.jit(jax_tail.apply)(
            {**variables, "int8_stats": stats}, x2))
        with torch.inference_mode():
            got2 = nhwc(tail(torch.from_numpy(x2).permute(0, 3, 1, 2)))
        np.testing.assert_array_equal(got2, want2)

    def test_static_without_calibration_raises(self):
        _, _, tail, x = tail_case(exact=True, static=True)
        with pytest.raises(RuntimeError, match="calibrated"):
            tail(torch.from_numpy(x).permute(0, 3, 1, 2))

    def test_rejects_v2(self):
        with pytest.raises(ValueError):
            pq.Int8ResNetTail(depth=50, version=2)


def trunk_case(static):
    """R50 trunk to block3 at output stride 16, exact batch norms and a
    single-tap root kernel: every float operation is exact."""
    rng = np.random.RandomState(4)
    cfg = Config({"architecture": "resnet_v1_50", "output_stride": 16,
                  "int8_trunk": True, "int8_static": static})
    images = (rng.rand(2, 70, 98, 3) * 255).astype(np.float32)
    variables = bn_statistics(
        JaxTrunk(cfg).init(jax.random.PRNGKey(2), images[:1]), rng, True)
    variables.pop("int8_stats", None)  # init's forward records maxima
    root = variables["params"]["resnet_v1_50"]["conv1"]
    root["kernel"] = single_tap(root["kernel"], rng)
    trunk = load_flax_variables(TruncatedBaseNetwork(cfg), variables).eval()
    return JaxTrunk(cfg), variables, trunk, images


class TestTrunk:
    @pytest.mark.parametrize("static", [False, True])
    def test_matches_jax(self, static):
        jax_trunk, variables, trunk, images = trunk_case(static)
        if static:
            want, stats = calibrate_jax(jax_trunk, variables, images)
            with torch.inference_mode(), pq.calibrating(trunk):
                got = trunk(torch.from_numpy(images))
            assert port_stats(trunk) == int8_stats({"int8_stats": stats})
        else:
            want = np.asarray(jax.jit(jax_trunk.apply)(variables, images))
            with torch.inference_mode():
                got = trunk(torch.from_numpy(images))
        assert got.shape == (2, 5, 6, 1024)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_bf16_output_dtype(self):
        cfg = Config({"architecture": "resnet_v1_50", "int8_trunk": True})
        trunk = TruncatedBaseNetwork(cfg, dtype=torch.bfloat16).eval()
        with torch.inference_mode():
            out = trunk(torch.rand(1, 64, 64, 3) * 255)
        assert out.dtype == torch.bfloat16 and out.shape[-1] == 1024


def exact_ssd_float_stage(flat, rng):
    """SSD's conv1/conv2 (the float stage of the int8 path) as single-tap
    kernels with biases in {-8, 0, 4}, in flat variables (in place)."""
    for key in flat:
        if "/vgg_16/conv1/" in key or "/vgg_16/conv2/" in key:
            flat[key] = (single_tap(flat[key], rng) if key.endswith("kernel")
                         else rng.choice([-8.0, 0.0, 4.0], flat[key].shape)
                         .astype(np.float32))
    return flat


@pytest.fixture(scope="module")
def ssd_extractor_init():
    """The float JAX extractor's init at 300x300 (flat numpy variables)
    and its variables' shapes, once for the module; and one jitted apply
    of the dynamic int8 extractor, whose compile the tests that run it
    share."""
    images = np.zeros((1, 300, 300, 3), np.float32)
    init = JaxExtractor(Config({})).init(jax.random.PRNGKey(3), images)
    return {"flat": flatten_variables(jax.tree_util.tree_map(np.asarray,
                                                            init)),
            "shapes": jax.tree_util.tree_map(
                lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), init),
            "apply": jax.jit(JaxExtractor(Config({
                "architecture": "truncated_vgg_16", "int8_trunk": True,
                "int8_static": False})).apply)}


def extractor_case(static, init, exact=True):
    """JAX's int8 extractor, its variables, the port's extractor and the
    image, from ``init`` (``ssd_extractor_init``: the float init, whose
    values do not depend on the image's)."""
    rng = np.random.RandomState(5)
    cfg = Config({"architecture": "truncated_vgg_16", "int8_trunk": True,
                  "int8_static": static})
    images = (rng.rand(1, 300, 300, 3) * 255 - 120).astype(np.float32)
    flat = {k: v.copy() for k, v in init["flat"].items()}
    for key in flat:  # biases off zero
        if key.endswith("/bias"):
            flat[key] = (rng.randn(*flat[key].shape) * 0.1).astype(
                np.float32)
    if exact:
        exact_ssd_float_stage(flat, rng)
    extractor = load_flax_variables(SSDFeatureExtractor(cfg), flat).eval()
    variables = jax.tree_util.tree_map_with_path(
        lambda path, _: flat["/".join(str(k.key) for k in path)],
        init["shapes"])
    return JaxExtractor(cfg), variables, extractor, images


class TestSSDMaps:
    @pytest.mark.parametrize("static", [False, True])
    def test_maps_match_jax(self, static, ssd_extractor_init):
        """All six maps (37, 18, 9, 5, 3 and 1 on a side) bitwise; conv4_3
        normalised in float32; calibrated maxima equal JAX's."""
        jax_ex, variables, extractor, images = extractor_case(
            static, ssd_extractor_init)
        nchw = torch.from_numpy(images).permute(0, 3, 1, 2)
        if static:
            want, stats = calibrate_jax(jax_ex, variables, images)
            with torch.inference_mode(), pq.calibrating(extractor):
                got = extractor(nchw)
            want_stats = int8_stats({"int8_stats": stats})
            assert len(want_stats) == 19
            assert port_stats(extractor) == want_stats
        else:
            want = ssd_extractor_init["apply"](variables, images)
            with torch.inference_mode():
                got = extractor(nchw)
        assert [g.shape[-1] for g in got] == [37, 18, 9, 5, 3, 1]
        # conv4_3_norm: float32 sums over channels in another order.
        np.testing.assert_allclose(nhwc(got[0]), np.asarray(want[0]),
                                   rtol=1e-6, atol=1e-6)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(nhwc(g), np.asarray(w))

    def test_random_float_stage_tracks_jax(self, ssd_extractor_init):
        """Random conv1/conv2: the float stage's summation order flips a
        few codes, and 13 int8 layers carry the flips on; every map within
        ``SSD_MAP_RTOL`` of its largest magnitude."""
        jax_ex, variables, extractor, images = extractor_case(
            False, ssd_extractor_init, exact=False)
        want = ssd_extractor_init["apply"](variables, images)
        with torch.inference_mode():
            got = extractor(torch.from_numpy(images).permute(0, 3, 1, 2))
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(nhwc(g), w, rtol=0,
                                       atol=SSD_MAP_RTOL * np.abs(w).max())

    def test_bf16_maps_are_bf16(self):
        extractor = SSDFeatureExtractor(Config({"int8_trunk": True})).eval()
        x = (torch.rand(1, 3, 300, 300) * 255 - 120).to(torch.bfloat16)
        with torch.inference_mode():
            maps = extractor(x.contiguous(memory_format=torch.channels_last))
        assert {m.dtype for m in maps} == {torch.bfloat16}


# ----------------------------------------- weights, calibration, serving


def frcnn_fast_config():
    config = torch_config.get_model_config(
        torch_config.get_base_config("fasterrcnn"), Config(CONFIG))
    return config, apply_serving_profile(copy.deepcopy(config), "fast")


def small_budgets(config):
    config.model.rpn.proposals.pre_nms_top_n = 128
    config.model.rpn.proposals.post_nms_top_n = 32
    return config


@pytest.fixture(scope="module")
def frcnn_fast():
    """The small Faster R-CNN (R50, 3 classes, 96x128) under the ``fast``
    profile (small RPN budgets), with the heads of
    ``test_torch_eval.rescaled_jax_variables``; the JAX predictor
    calibrated at load."""
    config, fast = frcnn_fast_config()
    fast = small_budgets(fast)
    variables = rescaled_jax_variables(config)
    want = JaxPredictor(fast, variables=variables, mesh=None)
    return fast, variables, want


def assert_paired(got, want, box_atol=BOX_ATOL, prob_atol=PROB_ATOL):
    """One image's detections: each object pairs one to one with an
    object of the same label, box and probability (ties in probability
    may come in either order)."""
    assert len(got) == len(want) > 0
    unmatched = list(want)
    for o in got:
        match = next((w for w in unmatched if w["label"] == o["label"]
                      and abs(w["prob"] - o["prob"]) <= prob_atol
                      and np.allclose(o["bbox"], w["bbox"], rtol=0,
                                      atol=box_atol)), None)
        assert match is not None, f"{o} has no counterpart"
        unmatched.remove(match)


class TestWeights:
    def test_int8_paths_follow_the_jax_collection(self, frcnn_fast):
        config, variables, want = frcnn_fast
        model = FasterRCNN(config)
        paths = {p for p in flax_paths(model).values()
                 if p.startswith("int8_stats/")}
        assert paths == set(int8_stats(want._variables))
        # Not in the state dict: .pt checkpoints keep their keys.
        assert not any("amax" in k for k in model.state_dict())
        assert set(flatten_variables(init_variables(config, 0))) == set(
            flatten_variables(variables))

    def test_jax_int8_stats_carry_over_both_ways(self, frcnn_fast):
        """Variables calibrated by the JAX predictor serve with its exact
        scales (no calibration) and come back unchanged."""
        config, _, want = frcnn_fast
        carried = jax.tree_util.tree_map(np.asarray, want._variables)
        network = predicting.PredictorNetwork(config, variables=carried,
                                              device="cpu")
        assert network.int8_calibration_s is None
        back = flax_variables_from_torch(network._model)
        assert port_stats(network._model) == int8_stats(carried)
        assert set(back) == set(flatten_variables(carried))

    def test_partial_stats_raise(self, frcnn_fast):
        config, variables, want = frcnn_fast
        flat = flatten_variables(jax.tree_util.tree_map(
            np.asarray, want._variables))
        flat.pop(sorted(int8_stats(want._variables))[0])
        with pytest.raises(KeyError, match="int8_stats"):
            load_flax_variables(FasterRCNN(config), flat)

    def test_a_float_model_ignores_int8_stats(self, frcnn_fast):
        config, variables, want = frcnn_fast
        float_config = frcnn_fast_config()[0]
        model = load_flax_variables(FasterRCNN(float_config), jax.tree_util
                                    .tree_map(np.asarray, want._variables))
        assert not pq.int8_modules(model)


class TestCalibration:
    def test_frcnn_scales_track_jax(self, frcnn_fast):
        config, variables, want = frcnn_fast
        got = predicting.PredictorNetwork(config, variables=variables,
                                          device="cpu")
        assert got.int8_calibration_s is not None
        got_stats, want_stats = port_stats(got._model), int8_stats(
            want._variables)
        assert set(got_stats) == set(want_stats) and len(got_stats) == 9
        # The tail's first maximum reads the float trunk's output.
        for key, value in want_stats.items():
            np.testing.assert_allclose(got_stats[key], value,
                                       rtol=FRCNN_SCALE_RTOL, err_msg=key)

class TestFastEndToEnd:
    def test_frcnn_detections_match_jax(self, frcnn_fast):
        config, variables, want = frcnn_fast
        got = predicting.PredictorNetwork(config, variables=variables,
                                          device="cpu")
        rng = np.random.RandomState(1)
        images = [rng.randint(0, 256, (80, 100, 3)).astype(np.uint8),
                  rng.randint(0, 256, (90, 120, 3)).astype(np.uint8)]
        for g, w in zip(got.predict_batch(images),
                        want.predict_batch(images)):
            assert [o["label"] for o in g] == [o["label"] for o in w]
            assert len(g) > 0
            np.testing.assert_allclose([o["bbox"] for o in g],
                                       [o["bbox"] for o in w], rtol=0,
                                       atol=FRCNN_BOX_ATOL)
            np.testing.assert_allclose([o["prob"] for o in g],
                                       [o["prob"] for o in w], rtol=0,
                                       atol=FRCNN_PROB_ATOL)

# -------------------------------------------------------------- training


class TestTraining:
    def test_trains_with_float_path_when_flag_set(self):
        """``int8_trunk`` is inert in training: the float trunk's output
        (the JAX ``train=True`` apply's, within float32 summation order)."""
        cfg = Config({"architecture": "resnet_v1_50", "output_stride": 16,
                      "int8_trunk": True})
        x = np.zeros((1, 64, 64, 3), np.float32)
        jax_net = JaxTrunk(cfg)
        variables = jax_net.init(jax.random.PRNGKey(0), x, train=True)
        want, _ = jax_net.apply(variables, x, train=True,
                                mutable=["batch_stats"])
        net = load_flax_variables(TruncatedBaseNetwork(cfg), variables)
        float_net = load_flax_variables(TruncatedBaseNetwork(Config({
            "architecture": "resnet_v1_50", "output_stride": 16})),
            variables)
        net.train(), float_net.train()
        got = net(torch.from_numpy(x))
        assert got.shape[-1] == 1024 and got.requires_grad
        assert torch.equal(got, float_net(torch.from_numpy(x)))
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())

    def test_train_step_ignores_the_flags(self):
        """One train step of Faster R-CNN with ``int8_tail`` and
        ``int8_trunk``: the losses and gradients of the float model."""
        config, _ = frcnn_fast_config()
        flagged = copy.deepcopy(config)
        flagged.model.base_network.int8_tail = True
        flagged.model.base_network.int8_trunk = True
        variables = init_variables(config, seed=2)
        rng = np.random.RandomState(0)
        images = torch.from_numpy(
            (rng.rand(2, 96, 128, 3) * 255).astype(np.float32))
        gt = torch.tensor([[[10, 12, 60, 50, 0], [40, 30, 120, 90, 2]],
                           [[5, 5, 90, 80, 1], [0, 0, 0, 0, -1]]],
                          dtype=torch.float32)
        results = []
        for cfg in (config, flagged):
            model = load_flax_variables(FasterRCNN(cfg), variables).train()
            generator = torch.Generator().manual_seed(0)
            losses = model.loss(model(images, gt_boxes=gt,
                                      generator=generator), return_all=True)
            grads = torch.autograd.grad(losses["total_loss"],
                                        [p for p in model.parameters()
                                         if p.requires_grad],
                                        allow_unused=True)
            results.append((losses, grads))
        (want, want_grads), (got, got_grads) = results
        for key in want:
            assert torch.equal(got[key], want[key]), key
        for g, w in zip(got_grads, want_grads):
            assert (g is None and w is None) or torch.equal(g, w)

    def test_train_run_takes_the_flags(self, tmp_path):
        cfg = _TrainRun()._config(tmp_path, write_records(tmp_path))
        cfg.model.base_network.int8_tail = True
        cfg.model.base_network.int8_trunk = True
        cfg.model.base_network.int8_static = True
        state = trainer.run(cfg, max_steps=1, device="cpu")
        assert state.step == 1 and np.isfinite(state.history[0]["total_loss"])
