"""Port's RPN and RCNN proposal stages against the JAX package.

Stage inputs are made the way the model makes them: RPN logits quantized
to bf16 before the float32 softmax (so scores tie often, as on the bf16
serving path), small random box deltas over the anchor grid. The JAX
stages run on CPU, the port on CPU tensors. Validity masks, indices and
labels must be equal; boxes agree to 1e-4 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luminoth_tpu.models.fasterrcnn.rcnn_proposal import (
    rcnn_proposal as jax_rcnn_proposal,
)
from luminoth_tpu.models.fasterrcnn.rpn_proposal import (
    rpn_proposal as jax_rpn_proposal,
)
from luminoth_tpu.ops.anchors import (
    generate_anchors_grid,
    generate_anchors_reference,
)
from luminoth_tpu_torch.models.fasterrcnn.rcnn_proposal import rcnn_proposal
from luminoth_tpu_torch.models.fasterrcnn.rpn_proposal import rpn_proposal

BOX_ATOL = 1e-4
IM_SHAPE = np.asarray([[90.0, 120.0], [96.0, 128.0]], np.float32)


def softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def bf16_round(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def rpn_inputs(rng, b=2):
    ref = generate_anchors_reference(256, [0.5, 1, 2], [0.25, 0.5, 1, 2])
    anchors = np.array(generate_anchors_grid(ref, 16, (6, 8)))
    a = anchors.shape[0]
    logits = bf16_round(rng.randn(b, a, 2) * 2.0)
    deltas = (rng.randn(b, a, 4) * 0.2).astype(np.float32)
    return softmax(logits), deltas, anchors


def compare(got, want, box_keys):
    for key, value in want.items():
        value = np.asarray(value)
        if key in box_keys:
            np.testing.assert_allclose(
                got[key].numpy(), value, rtol=0, atol=BOX_ATOL, err_msg=key
            )
        else:
            np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


class TestRPNProposal:
    @pytest.mark.parametrize("options", [
        {},
        {"filter_outside_anchors": True, "min_size": 16},
        {"clip_after_nms": True, "min_prob_threshold": 0.3},
        {"apply_nms": False},
        {"pre_nms_top_n": 2000, "post_nms_top_n": 600},
    ])
    def test_matches_jax(self, rng, options):
        probs, deltas, anchors = rpn_inputs(rng)
        kwargs = {"pre_nms_top_n": 300, "post_nms_top_n": 50,
                  "nms_threshold": 0.7, **options}
        want = jax_rpn_proposal(
            jnp.asarray(probs), jnp.asarray(deltas), jnp.asarray(anchors),
            jnp.asarray(IM_SHAPE), **kwargs,
        )
        got = rpn_proposal(
            torch.from_numpy(probs), torch.from_numpy(deltas),
            torch.from_numpy(anchors), torch.from_numpy(IM_SHAPE), **kwargs,
        )
        # The scores of masked slots are 0 on both sides; ties are common
        # (bf16 logits), so equal proposals prove the tie order matches.
        compare(got, want, box_keys=("proposals",))

    def test_unbatched(self, rng):
        probs, deltas, anchors = rpn_inputs(rng, b=1)
        want = jax_rpn_proposal(
            jnp.asarray(probs[0]), jnp.asarray(deltas[0]),
            jnp.asarray(anchors), IM_SHAPE[0], pre_nms_top_n=200,
            post_nms_top_n=40,
        )
        got = rpn_proposal(
            torch.from_numpy(probs[0]), torch.from_numpy(deltas[0]),
            torch.from_numpy(anchors), IM_SHAPE[0], pre_nms_top_n=200,
            post_nms_top_n=40,
        )
        compare(got, want, box_keys=("proposals",))


def rcnn_inputs(rng, b=2, p=120, c=4):
    xy = rng.uniform(0, 90, (b, p, 2))
    wh = rng.uniform(8, 50, (b, p, 2))
    proposals = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    deltas = (rng.randn(b, p, 4 * c) * 0.5).astype(np.float32)
    probs = softmax(rng.randn(b, p, c + 1) * 2.0)
    valid = rng.rand(b, p) > 0.15
    return proposals, deltas, probs, valid, c


class TestRCNNProposal:
    @pytest.mark.parametrize("pre_nms_max_candidates", [0, 40])
    @pytest.mark.parametrize("min_prob", [0.0, 0.2])
    def test_matches_jax(self, rng, pre_nms_max_candidates, min_prob):
        proposals, deltas, probs, valid, c = rcnn_inputs(rng)
        kwargs = {
            "class_max_detections": 12, "class_nms_threshold": 0.5,
            "total_max_detections": 30, "min_prob_threshold": min_prob,
            "variances": (0.1, 0.2),
            "pre_nms_max_candidates": pre_nms_max_candidates,
        }
        want = jax_rcnn_proposal(
            jnp.asarray(proposals), jnp.asarray(deltas), jnp.asarray(probs),
            jnp.asarray(valid), jnp.asarray(IM_SHAPE), c, **kwargs,
        )
        got = rcnn_proposal(
            torch.from_numpy(proposals), torch.from_numpy(deltas),
            torch.from_numpy(probs), torch.from_numpy(valid),
            torch.from_numpy(IM_SHAPE), c, **kwargs,
        )
        compare(got, want, box_keys=("objects",))
        assert got["valid"].any()

    def test_unbatched(self, rng):
        proposals, deltas, probs, valid, c = rcnn_inputs(rng, b=1)
        want = jax_rcnn_proposal(
            jnp.asarray(proposals[0]), jnp.asarray(deltas[0]),
            jnp.asarray(probs[0]), jnp.asarray(valid[0]), IM_SHAPE[0], c,
            class_max_detections=10, total_max_detections=20,
        )
        got = rcnn_proposal(
            torch.from_numpy(proposals[0]), torch.from_numpy(deltas[0]),
            torch.from_numpy(probs[0]), torch.from_numpy(valid[0]),
            IM_SHAPE[0], c, class_max_detections=10, total_max_detections=20,
        )
        compare(got, want, box_keys=("objects",))
