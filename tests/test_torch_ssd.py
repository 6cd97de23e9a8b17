"""The port's SSD against the JAX package's, module by module (CPU).

SSD at the base config's widths (truncated VGG-16, 300x300 input, 8096
anchors) with 3 classes, batch 2. The weights are the port's random init
(``utils/weights.init_variables``, flax's initializers) in the JAX
package's layout, so both models hold the same numbers. One JAX forward
and one port forward of the same images and ground truth are shared by
the module.

Tolerances: the VGG endpoints (on a unit-scale input: the model's own
input reaches ~400 at conv1, where float32 rounding alone is 3e-5), the six
feature maps and the heads within atol 1e-4; anchors exact; detections
of the model with equal ``valid`` and labels, boxes within 1e-3 px and
probabilities within 1e-5; both proposal paths on crafted probabilities
(exact ties, a probability of exactly 0.5, overlapping boxes of different
classes, zero offsets) exactly equal, on random ones equal but for boxes
within 1e-4 px; targets exact in class and within 1e-6 in offsets,
ties included; the loss within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from luminoth_tpu.models.base.vgg import VGG16 as JaxVGG16
from luminoth_tpu.models.ssd import SSD as JaxSSD
from luminoth_tpu.models.ssd.proposal import ssd_proposal as jax_proposal
from luminoth_tpu.models.ssd.target import ssd_target_assign as jax_assign
from luminoth_tpu.utils.config import Config, to_plain
from luminoth_tpu.utils.predicting import PredictorNetwork as JaxPredictor
from luminoth_tpu_torch.models import get_model
from luminoth_tpu_torch.models.base.vgg import VGG16
from luminoth_tpu_torch.models.ssd import SSD
from luminoth_tpu_torch.models.ssd.proposal import ssd_proposal
from luminoth_tpu_torch.models.ssd.target import ssd_target_assign
from luminoth_tpu_torch.tasks import Detector
from luminoth_tpu_torch.utils import config as torch_config
from luminoth_tpu_torch.utils import predicting
from luminoth_tpu_torch.utils.weights import (
    flatten_variables,
    flax_variables_from_torch,
    init_variables,
    load_flax_variables,
)
from test_torch_isolation import few_threads, jax_cache_isolation  # noqa: F401

MAP_ATOL = 1e-4
BOX_ATOL = 1e-3  # px, the model's detections
PROPOSAL_BOX_ATOL = 1e-4  # px, random offsets
PROB_ATOL = 1e-5
OFFSET_ATOL = 1e-6
LOSS_RTOL = 1e-5
PREDICT_PROB_ATOL = 1e-4 + 1e-5  # the predictor rounds to 4 decimals
SIZE = 300
VARIANCES = (0.1, 0.2)
OVERRIDES = {"model": {"network": {"num_classes": 3}}}
GT = np.asarray([
    [[20, 30, 140, 160, 0], [150, 100, 290, 280, 2], [60, 180, 120, 260, 1],
     [0, 0, 0, 0, -1]],
    [[100, 100, 220, 200, 1], [0, 0, 0, 0, -1], [0, 0, 0, 0, -1],
     [0, 0, 0, 0, -1]],
], np.float32)


def small_config(num_classes=3):
    """The SSD base config with ``num_classes`` classes (the port's)."""
    return torch_config.get_model_config(
        torch_config.get_base_config("ssd"),
        Config({"model": {"network": {"num_classes": num_classes}}}))


def jax_variables(config, variables):
    """``variables`` (any flax layout) nested as the JAX SSD's pytree, whose
    module names may hold a ``/`` (``vgg_16/conv1/conv1_1``)."""
    flat = flatten_variables(variables)
    shapes = jax.eval_shape(lambda: JaxSSD(to_plain(config)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))
    return jax.tree_util.tree_map_with_path(
        lambda path, _: flat["/".join(str(k.key) for k in path)], shapes)


def nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def config():
    return small_config()


@pytest.fixture(scope="module")
def variables(config):
    return jax_variables(config, init_variables(config, seed=0))


@pytest.fixture(scope="module")
def images():
    return (np.random.RandomState(0).rand(2, SIZE, SIZE, 3) * 255).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_out(config, variables, images):
    """The JAX forward with ground truth, outside training (targets and
    detections), and the feature extractor's maps."""
    preds, inter = JaxSSD(to_plain(config)).apply(
        variables, jnp.asarray(images), gt_boxes=jnp.asarray(GT),
        train=False, capture_intermediates=True, mutable=["intermediates"])
    maps = inter["intermediates"]["feature_extractor"]["__call__"][0]
    return preds, [np.asarray(m) for m in maps]


@pytest.fixture(scope="module")
def port_out(config, variables, images):
    model = load_flax_variables(SSD(config), variables).eval()
    captured = {}
    model.feature_extractor.register_forward_hook(
        lambda module, args, out: captured.setdefault("maps", out))
    with torch.inference_mode():
        preds = model(torch.from_numpy(images),
                      gt_boxes=torch.from_numpy(GT))
    return model, preds, [nhwc(m) for m in captured["maps"]]


# ----------------------------------------------------------- the layers


VGG_ENDPOINTS = [f"conv{s}/conv{s}_{i}" for s, n in
                 ((1, 2), (2, 2), (3, 3), (4, 3), (5, 3))
                 for i in range(1, n + 1)] + [
    "pool1", "pool2", "pool3", "pool4", "output"]


@pytest.fixture(scope="module")
def vgg_endpoints(variables):
    """Both VGG-16s on one unit-scale 300x300 input."""
    x = np.random.RandomState(1).uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(
        np.float32)
    params = {"params": variables["params"]["feature_extractor"]["vgg_16"]}
    _, want = JaxVGG16(truncated=True).apply(params, jnp.asarray(x))
    vgg = load_flax_variables(VGG16(), params)
    with torch.inference_mode():
        _, got = vgg(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
    return got, want


@pytest.mark.parametrize("name", VGG_ENDPOINTS)
def test_vgg_endpoint_matches_jax(vgg_endpoints, name):
    got, want = vgg_endpoints
    assert set(got) == set(want)
    np.testing.assert_allclose(nhwc(got[name]), np.asarray(want[name]),
                               rtol=0, atol=MAP_ATOL)


@pytest.mark.parametrize("index,side", list(enumerate((37, 18, 9, 5, 3, 1))))
def test_feature_map_matches_jax(jax_out, port_out, index, side):
    """Every map, the L2-normalised conv4_3 and the asymmetric SAME pads
    of conv8_2 (0, 1) and conv9_2 (1, 1) included."""
    want, got = jax_out[1][index], port_out[2][index]
    assert len(port_out[2]) == 6
    assert got.shape == want.shape and got.shape[1:3] == (side, side)
    np.testing.assert_allclose(got, want, rtol=0, atol=MAP_ATOL)


@pytest.mark.parametrize("key", ["cls_pred", "loc_pred"])
def test_heads_match_jax(jax_out, port_out, key):
    want, got = np.asarray(jax_out[0][key]), port_out[1][key].numpy()
    assert got.shape == want.shape == (2, 8096, 4)  # 4 offsets, 3 + 1 logits
    np.testing.assert_allclose(got, want, rtol=0, atol=MAP_ATOL)


def test_anchors_equal_jax(jax_out, port_out):
    want = np.asarray(jax_out[0]["anchors"])
    got = port_out[1]["anchors"].numpy()
    assert got.shape == (8096, 4)
    np.testing.assert_array_equal(got, want)


def test_detections_match_jax(jax_out, port_out):
    """The model's detections on the fused path (base config: min_prob
    0.5, class cap 100 = total cap)."""
    want = {k: np.asarray(v) for k, v in
            jax_out[0]["classification_prediction"].items()}
    got = {k: v.numpy() for k, v in
           port_out[1]["classification_prediction"].items()}
    valid = want["valid"]
    np.testing.assert_array_equal(got["valid"], valid)
    assert valid.sum() > 10  # some random-init probabilities pass 0.5
    np.testing.assert_array_equal(got["labels"][valid], want["labels"][valid])
    np.testing.assert_allclose(got["objects"][valid], want["objects"][valid],
                               rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(got["probs"][valid], want["probs"][valid],
                               rtol=0, atol=PROB_ATOL)


def test_model_targets_match_jax(jax_out, port_out):
    want, got = jax_out[0]["target"], port_out[1]["target"]
    np.testing.assert_array_equal(got["cls"].numpy(), np.asarray(want["cls"]))
    np.testing.assert_allclose(got["bbox_offsets"].numpy(),
                               np.asarray(want["bbox_offsets"]), rtol=0,
                               atol=OFFSET_ATOL)
    assert (got["cls"] > 0).sum() >= 4 and (got["cls"] == 0).sum() > 0


def test_loss_matches_jax(config, jax_out, port_out):
    want = JaxSSD(to_plain(config)).loss(jax_out[0], return_all=True)
    got = port_out[0].loss(port_out[1], return_all=True)
    assert set(got) == set(want) == {"total_loss", "cls_loss", "bbox_loss"}
    for key, value in want.items():
        assert float(got[key]) > 0
        np.testing.assert_allclose(float(got[key]), float(value),
                                   rtol=LOSS_RTOL, err_msg=key)


def test_loss_of_an_image_without_positives_is_zero(config, port_out):
    model, preds = port_out[0], port_out[1]
    target = {"cls": torch.where(preds["target"]["cls"] > 0, 0.0,
                                 preds["target"]["cls"]),
              "bbox_offsets": preds["target"]["bbox_offsets"]}
    assert float(model.loss({**preds, "target": target})) == 0.0


# ------------------------------------------------------------ proposals


def _anchors(rng, count):
    """Clustered boxes in 300x300, some repeated exactly."""
    centers = rng.uniform(40, 260, (count // 4, 2)).repeat(4, axis=0)
    centers += rng.normal(0, 6, centers.shape)
    sizes = rng.uniform(20, 80, (count, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], 1)
    boxes[1::8] = boxes[0::8]  # exact duplicates
    return boxes.astype(np.float32)


def crafted_probs(rng, batch, anchors, classes):
    """Few distinct probabilities, so ties are everywhere: most anchors
    below 0.5 in every class, runs of equal winners, a class at exactly
    0.5 (and background at 0.5), and the same box confident in two
    classes on two anchors (islands of the fused path)."""
    fg = rng.choice([0.05, 0.1, 0.2, 0.2, 0.3], (batch, anchors, classes))
    probs = np.concatenate([1.0 - fg.sum(-1, keepdims=True) / 2, fg / 2], -1)
    winners = rng.random((batch, anchors)) < 0.4
    cls = rng.integers(0, classes, (batch, anchors))
    level = rng.choice([0.5, 0.75, 0.75, 0.9], (batch, anchors))
    for b, a in zip(*np.nonzero(winners)):
        probs[b, a] = 0.0
        probs[b, a, 1 + cls[b, a]] = level[b, a]
        probs[b, a, 0] = 1.0 - level[b, a]
    probs[:, 1::8] = probs[:, 0::8]  # duplicate boxes, equal probabilities
    probs[:, 9::16, 1:] = np.roll(probs[:, 9::16, 1:], 1, axis=-1)  # islands
    return probs.astype(np.float32)


PROPOSAL_CASES = {
    # name: (crafted, min_prob, class cap, total cap, candidate cap)
    "fused_crafted": (True, 0.5, 100, 100, 1000),
    "fused_crafted_capped": (True, 0.5, 20, 20, 48),
    "per_class_crafted": (True, 0.0, 8, 20, 1000),
    "per_class_crafted_capped": (True, 0.1, 8, 20, 40),
    "per_class_high_floor": (True, 0.5, 5, 20, 1000),  # class cap < total
    "fused_random": (False, 0.5, 100, 100, 1000),
    "per_class_random": (False, 0.05, 30, 50, 100),
}


@pytest.mark.parametrize("case", list(PROPOSAL_CASES))
def test_proposal_matches_jax(case):
    crafted, min_prob, class_max, total_max, cap = PROPOSAL_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    batch, count, classes = 2, 160, 3
    anchors = _anchors(rng, count)
    if crafted:
        probs = crafted_probs(rng, batch, count, classes)
        offsets = np.zeros((batch, count, 4), np.float32)
    else:
        logits = rng.standard_normal((batch, count, classes + 1)) * 3.0
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        probs = probs.astype(np.float32)
        offsets = (rng.standard_normal((batch, count, 4)) * 0.3).astype(
            np.float32)
    args = dict(num_classes=classes, class_nms_threshold=0.45,
                class_max_detections=class_max,
                total_max_detections=total_max, min_prob_threshold=min_prob,
                variances=VARIANCES, pre_nms_max_candidates=cap)
    want = {k: np.asarray(v) for k, v in jax_proposal(
        jnp.asarray(probs), jnp.asarray(offsets), jnp.asarray(anchors),
        (float(SIZE), float(SIZE)), **args).items()}
    got = {k: v.numpy() for k, v in ssd_proposal(
        torch.from_numpy(probs), torch.from_numpy(offsets),
        torch.from_numpy(anchors), (SIZE, SIZE), **args).items()}
    assert set(got) == set(want)
    valid = want["valid"]
    assert valid.sum() > 5
    np.testing.assert_array_equal(got["valid"], valid)
    for key in ("labels", "probs"):
        np.testing.assert_array_equal(got[key][valid], want[key][valid],
                                      err_msg=key)
    atol = 0.0 if crafted else PROPOSAL_BOX_ATOL
    np.testing.assert_allclose(got["objects"][valid], want["objects"][valid],
                               rtol=0, atol=atol)
    if case.startswith("fused_crafted"):
        # Islands: the same box survives in two classes on one image.
        boxes = [tuple(o) + (int(lab),) for o, lab in
                 zip(got["objects"][0][valid[0]], got["labels"][0][valid[0]])]
        assert len({b[:4] for b in boxes}) < len(boxes)


# -------------------------------------------------------------- targets


def _real_anchors(config):
    return SSD(config).anchors.numpy()


def target_case(case, config):
    """``(probs (B, A, 4), anchors (A, 4), gt (B, G, 5))`` of ``case``."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case in ("random", "uniform_ties", "no_gt", "padded_gt"):
        anchors = _real_anchors(config)
        a = anchors.shape[0]
        if case == "random":
            probs = rng.dirichlet(np.ones(4), (2, a))
        else:  # every anchor the same: hard mining is all ties
            probs = np.full((2, a, 4), 0.25)
        gt = GT.copy()
        if case == "no_gt":
            gt[..., 4] = -1
        if case == "padded_gt":
            gt[1, 0, 4] = -1  # an image whose only gt is padding
        return probs.astype(np.float32), anchors, gt
    # The four-anchor scenarios of tests/test_ssd.py.
    anchors = np.asarray([[0, 0, 99, 99], [100, 100, 199, 199], [0, 0, 9, 9],
                          [200, 200, 250, 250]], np.float32)
    probs = np.full((1, 4, 4), 0.25, np.float32)
    gt = {
        "foreground_by_iou": [[0, 0, 99, 99, 1]],
        "best_anchor_override": [[0, 0, 30, 30, 0]],
        "hard_negative_ratio": [[0, 0, 99, 99, 1]],
        "shared_best_anchor": [[0, 0, 50, 50, 0], [0, 0, 54, 54, 2]],
    }[case]
    if case == "hard_negative_ratio":
        probs = np.asarray([[[0.1, 0.9, 0, 0], [0.2, 0.8, 0, 0],
                             [0.3, 0.7, 0, 0], [0.9, 0.1, 0, 0]]],
                           np.float32)
    return probs, anchors, np.asarray([gt], np.float32)


@pytest.mark.parametrize("case", [
    "foreground_by_iou", "best_anchor_override", "hard_negative_ratio",
    "shared_best_anchor", "random", "uniform_ties", "no_gt", "padded_gt"])
def test_target_assign_matches_jax(config, case):
    probs, anchors, gt = target_case(case, config)
    args = dict(num_classes=3, foreground_threshold=0.5,
                background_threshold_high=0.2, hard_negative_ratio=3.0,
                variances=VARIANCES)
    got_cls, got_off = ssd_target_assign(
        torch.from_numpy(probs), torch.from_numpy(anchors),
        torch.from_numpy(gt), **args)
    for b in range(probs.shape[0]):
        want_cls, want_off = jax_assign(jnp.asarray(probs[b]),
                                        jnp.asarray(anchors),
                                        jnp.asarray(gt[b]), **args)
        np.testing.assert_array_equal(got_cls[b].numpy(),
                                      np.asarray(want_cls))
        np.testing.assert_allclose(got_off[b].numpy(), np.asarray(want_off),
                                   rtol=0, atol=OFFSET_ATOL)
    fg = int((got_cls > 0).sum())
    if case == "no_gt":
        assert fg == 0 and not got_off.any()
    else:
        assert fg > 0
    if case == "uniform_ties":
        # The tie rule: the mined backgrounds are the first candidates.
        bg = torch.nonzero(got_cls[0] == 0).flatten()
        assert len(bg) == 3 * int((got_cls[0] > 0).sum())


# -------------------------------------------------------------- weights


def test_weights_round_trip_the_full_20_class_tree():
    """Every leaf of the JAX SSD's pytree at 20 classes (26,285,486
    parameters, ``conv4_3_norm/gamma`` included) goes into the port and
    comes back unchanged."""
    config = small_config(20)
    shapes = jax.eval_shape(lambda: JaxSSD(to_plain(config)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    want = flatten_variables(tree)
    assert sum(v.size for v in want.values()) == 26285486
    assert want["params/feature_extractor/conv4_3_norm/gamma"].shape == (
        1, 1, 1, 512)
    model = load_flax_variables(SSD(config), tree)
    got = flax_variables_from_torch(model)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_get_model_and_init_variables():
    config = small_config()
    assert get_model("ssd") is SSD
    assert set(flatten_variables(init_variables(config, 1))) == set(
        flatten_variables(jax_variables(config, init_variables(config, 2))))
    gamma = flatten_variables(init_variables(config, 1))[
        "params/feature_extractor/conv4_3_norm/gamma"]
    assert (gamma == 20.0).all()


def test_map_shapes_and_the_anchor_buffer(config):
    model = SSD(config)
    assert [tuple(s) for s in model.fm_shapes] == [
        (37, 37), (18, 18), (9, 9), (5, 5), (3, 3), (1, 1)]
    assert model.state_dict().keys().isdisjoint({"anchors"})


# ------------------------------------------------------------ predicting


def predictor_images():
    rng = np.random.RandomState(1)
    return [rng.randint(0, 256, (240, 320, 3)).astype(np.uint8),
            rng.randint(0, 256, (330, 280, 3)).astype(np.uint8)]


def assert_objects_close(got, want):
    """One image's ``{bbox, label, prob}`` lists: sorted by probability,
    the same probabilities, and each object paired one to one with an
    object of the same label, box and probability. Two objects whose
    probabilities tie within float32 noise may come in either order (the
    predictor sorts them by probability alone)."""
    assert len(got) == len(want) > 0
    probs = [o["prob"] for o in got]
    assert probs == sorted(probs, reverse=True)
    np.testing.assert_allclose(probs, [o["prob"] for o in want], rtol=0,
                               atol=PREDICT_PROB_ATOL)
    unmatched = list(want)
    for o in got:
        match = next((w for w in unmatched if w["label"] == o["label"]
                      and abs(w["prob"] - o["prob"]) <= PREDICT_PROB_ATOL
                      and np.allclose(o["bbox"], w["bbox"], rtol=0,
                                      atol=BOX_ATOL)), None)
        assert match is not None, f"{o} has no counterpart in {want}"
        unmatched.remove(match)


def test_predict_batch_matches_jax(config, variables):
    want = JaxPredictor(config, variables=variables, mesh=None)
    got = predicting.PredictorNetwork(config, variables, device="cpu")
    images = predictor_images()
    g, w = got.predict_batch(images), want.predict_batch(images)
    assert len(g) == len(w) == 2
    for g_objs, w_objs in zip(g, w):
        assert_objects_close(g_objs, w_objs)


def test_detector_from_an_ssd_config(config, variables, tmp_path):
    path = tmp_path / "ssd.yml"
    path.write_text(yaml.safe_dump({"model": {"type": "ssd", **OVERRIDES[
        "model"]}}))
    detector = Detector(config=str(path), variables=variables, device="cpu",
                        prob=0.0)
    network = predicting.PredictorNetwork(config, variables, device="cpu")
    images = predictor_images()
    assert network._canvas == (SIZE, SIZE)
    assert detector.predict(images) == network.predict_batch(images,
                                                             pad_to=2)
