"""Port's box geometry, anchors and losses against the JAX package (CPU,
float32)."""

import numpy as np
import pytest
import torch

from luminoth_tpu.ops import anchors as jax_anchors
from luminoth_tpu.ops import boxes as jax_boxes
from luminoth_tpu.ops import losses as jax_losses
from luminoth_tpu_torch.ops import anchors as torch_anchors
from luminoth_tpu_torch.ops import boxes as torch_boxes
from luminoth_tpu_torch.ops import losses as torch_losses

RTOL, ATOL = 1e-6, 1e-4  # px


def random_boxes(rng, shape, spread=200.0):
    x1 = rng.uniform(-20, spread, shape)
    y1 = rng.uniform(-20, spread, shape)
    w = rng.uniform(1, 80, shape)
    h = rng.uniform(1, 80, shape)
    return np.stack([x1, y1, x1 + w, y1 + h], axis=-1).astype(np.float32)


def assert_close(got, want):
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL
    )


class TestBoxes:
    def test_encode_decode(self, rng):
        boxes = random_boxes(rng, (3, 50))
        gt = random_boxes(rng, (3, 50))
        for variances in (None, (0.1, 0.2)):
            deltas = torch_boxes.encode(
                torch.from_numpy(boxes), torch.from_numpy(gt), variances
            )
            assert_close(deltas, jax_boxes.encode(boxes, gt, variances))
            decoded = torch_boxes.decode(
                torch.from_numpy(boxes), deltas, variances
            )
            assert_close(decoded, jax_boxes.decode(
                boxes, np.asarray(deltas.numpy()), variances
            ))
            # encode∘decode is the identity under the +1/−1 conventions.
            assert_close(decoded, gt)

    def test_clip_boxes(self, rng):
        boxes = random_boxes(rng, (4, 30), spread=150.0)
        im_shape = np.asarray(
            [[90, 120], [100, 80], [150, 150], [60, 200]], np.float32
        )
        got = torch_boxes.clip_boxes(
            torch.from_numpy(boxes), torch.from_numpy(im_shape)
        )
        assert_close(got, jax_boxes.clip_boxes(boxes, im_shape))
        got = torch_boxes.clip_boxes(torch.from_numpy(boxes[0]), (90.0, 120.0))
        assert_close(got, jax_boxes.clip_boxes(boxes[0], (90.0, 120.0)))

    @pytest.mark.parametrize("offset", [0.0, 1.0])
    def test_iou_matrix(self, rng, offset):
        a = random_boxes(rng, (2, 20), spread=60.0)
        b = random_boxes(rng, (2, 25), spread=60.0)
        a[0, 0] = [5, 5, 5, 5]  # degenerate: the 1e-8 union guard
        got = torch_boxes.iou_matrix(
            torch.from_numpy(a), torch.from_numpy(b), offset=offset
        )
        assert_close(got, jax_boxes.iou_matrix(a, b, offset=offset))


class TestAnchors:
    def test_reference(self):
        args = (256, [0.5, 1, 2], [0.25, 0.5, 1, 2])
        np.testing.assert_array_equal(
            torch_anchors.generate_anchors_reference(*args),
            jax_anchors.generate_anchors_reference(*args),
        )
        with pytest.raises(ValueError):
            torch_anchors.generate_anchors_reference(1, [0.5], [0.1])

    @pytest.mark.parametrize("fm_shape", [(6, 8), (38, 50)])
    def test_grid_order(self, fm_shape):
        ref = jax_anchors.generate_anchors_reference(
            256, [0.5, 1, 2], [0.25, 0.5, 1, 2]
        )
        got = torch_anchors.generate_anchors_grid(ref, 16, fm_shape)
        want = jax_anchors.generate_anchors_grid(ref, 16, fm_shape)
        assert got.shape == (fm_shape[0] * fm_shape[1] * 12, 4)
        assert_close(got, want)


class TestLosses:
    @pytest.mark.parametrize("sigma", [1.0, 3.0])
    def test_smooth_l1(self, rng, sigma):
        pred = rng.randn(6, 10, 4).astype(np.float32)
        target = rng.randn(6, 10, 4).astype(np.float32) * 0.3
        got = torch_losses.smooth_l1_loss(
            torch.from_numpy(pred), torch.from_numpy(target), sigma=sigma
        )
        want = jax_losses.smooth_l1_loss(pred, target, sigma=sigma)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)

    def test_softmax_cross_entropy(self, rng):
        logits = (rng.randn(20, 5) * 4).astype(np.float32)
        labels = np.eye(5, dtype=np.float32)[rng.randint(0, 5, 20)] * 0.9 + 0.02
        got = torch_losses.softmax_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels)
        )
        want = jax_losses.softmax_cross_entropy(logits, labels)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
