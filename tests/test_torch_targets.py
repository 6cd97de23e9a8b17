"""The port's top-k mask, target assignment and minibatch selection against
the JAX package (CPU).

The JAX functions draw their subsampling priorities as
``uniform(split(key)[i], (n,))``; the same uniforms are computed here with
``jax.random`` and handed to the port. Labels and indices must be equal,
box targets agree to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luminoth_tpu.models.fasterrcnn.rcnn_target import (
    rcnn_target_assign as jax_rcnn_target_assign,
    select_minibatch as jax_select_minibatch,
)
from luminoth_tpu.models.fasterrcnn.rpn_target import (
    rpn_target_assign as jax_rpn_target_assign,
)
from luminoth_tpu.ops.anchors import (
    generate_anchors_grid,
    generate_anchors_reference,
)
from luminoth_tpu.ops.select import top_k_mask as jax_top_k_mask
from luminoth_tpu_torch.models.fasterrcnn.rcnn_target import (
    rcnn_target_assign,
    select_minibatch,
)
from luminoth_tpu_torch.models.fasterrcnn.rpn_target import rpn_target_assign
from luminoth_tpu_torch.ops.select import top_k_mask
from test_torch_isolation import few_threads  # noqa: F401

TARGET_TOL = 1e-6


def jax_priorities(keys, n):
    """The (fg, bg) uniforms ``_keep_random_quota`` draws, per image key."""
    fg, bg = [], []
    for key in keys:
        fg_key, bg_key = jax.random.split(key)
        fg.append(np.asarray(jax.random.uniform(fg_key, (n,))))
        bg.append(np.asarray(jax.random.uniform(bg_key, (n,))))
    return torch.from_numpy(np.stack(fg)), torch.from_numpy(np.stack(bg))


def tie_heavy_scores(rng, shape):
    """Scores from few distinct values, with signed zeros and -1 floors."""
    values = np.asarray([-1.0, -0.0, 0.0, 0.25, 0.5, 0.5, 0.75, 1.0],
                        np.float32)
    return values[rng.randint(0, len(values), shape)]


class TestTopKMask:
    @pytest.mark.parametrize("k", [0, 1, 3, 7, 40, 64, 100])
    def test_matches_jax_with_ties(self, rng, k):
        scores = tie_heavy_scores(rng, (5, 64))
        got = top_k_mask(torch.from_numpy(scores), k).numpy()
        for row, got_row in zip(scores, got):
            want = np.asarray(jax_top_k_mask(jnp.asarray(row), k))
            np.testing.assert_array_equal(got_row, want)

    def test_per_row_quota_matches_jax(self, rng):
        scores = np.concatenate([
            tie_heavy_scores(rng, (4, 300)),
            rng.uniform(size=(4, 300)).astype(np.float32),
        ])
        quotas = np.asarray([0, 5, 150, 299, 300, 301, -3, 77])
        got = top_k_mask(torch.from_numpy(scores), torch.from_numpy(quotas))
        for row, k, got_row in zip(scores, quotas, got.numpy()):
            want = np.asarray(jax_top_k_mask(jnp.asarray(row), int(k)))
            np.testing.assert_array_equal(got_row, want)


class TestSelectMinibatch:
    @pytest.mark.parametrize("minibatch", [4, 16, 40])
    def test_matches_jax(self, rng, minibatch):
        labels = rng.choice([-1.0, -1.0, 0.0, 2.0, -3.0], (3, 40))
        labels = labels.astype(np.float32)
        idx, mask = select_minibatch(torch.from_numpy(labels), minibatch)
        for row, got_idx, got_mask in zip(labels, idx, mask):
            want_idx, want_mask = jax_select_minibatch(
                jnp.asarray(row), minibatch)
            np.testing.assert_array_equal(got_idx.numpy(), want_idx)
            np.testing.assert_array_equal(got_mask.numpy(), want_mask)


def random_gt(rng, batch, count, height, width, max_gt, classes=4):
    gt = np.zeros((batch, max_gt, 5), np.float32)
    gt[..., 4] = -1
    for b in range(batch):
        n = count[b]
        x1 = rng.uniform(0, width * 0.7, n)
        y1 = rng.uniform(0, height * 0.7, n)
        gt[b, :n] = np.stack([
            x1, y1, x1 + rng.uniform(8, width * 0.4, n),
            y1 + rng.uniform(8, height * 0.4, n), rng.randint(0, classes, n),
        ], -1)
    return gt


class TestRPNTarget:
    @pytest.mark.parametrize("clobber,minibatch", [(False, 256), (True, 64)])
    def test_matches_jax(self, rng, clobber, minibatch):
        reference = generate_anchors_reference(
            256, np.asarray([0.5, 1, 2.0]), np.asarray([0.25, 0.5, 1, 2.0]))
        anchors = np.array(
            generate_anchors_grid(reference, 16, (6, 8)), np.float32)
        gt = random_gt(rng, 3, [3, 1, 0], 96, 128, 4)
        gt[0, 1] = gt[0, 0]  # a duplicate gt: IoU ties per anchor
        im_shape = np.asarray([[96, 128], [80, 100], [96, 128]], np.float32)
        keys = jax.random.split(jax.random.PRNGKey(7), 3)
        kwargs = dict(clobber_positives=clobber, minibatch_size=minibatch,
                      foreground_fraction=0.5, foreground_threshold=0.5)
        want = jax.vmap(
            lambda g, s, k: jax_rpn_target_assign(anchors, g, s, k, **kwargs)
        )(jnp.asarray(gt), jnp.asarray(im_shape), keys)
        got = rpn_target_assign(
            torch.from_numpy(anchors), torch.from_numpy(gt),
            torch.from_numpy(im_shape),
            jax_priorities(keys, anchors.shape[0]), **kwargs,
        )
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=TARGET_TOL, atol=TARGET_TOL)
        labels = got[0].numpy()
        assert (labels == 1).any() and (labels == 0).any()
        assert ((labels >= 0).sum(axis=1) <= minibatch).all()


class TestRCNNTarget:
    @pytest.mark.parametrize("minibatch", [8, 32])
    def test_matches_jax(self, rng, minibatch):
        b, p = 3, 40
        gt = random_gt(rng, b, [4, 2, 0], 96, 128, 5)
        gt[1, 2] = gt[1, 1]  # two gts claiming one proposal: last wins
        gt[1, 2, 4] = 3
        proposals = np.zeros((b, p, 4), np.float32)
        for i in range(b):
            x1 = rng.uniform(0, 90, p)
            y1 = rng.uniform(0, 60, p)
            proposals[i] = np.stack([x1, y1, x1 + rng.uniform(5, 60, p),
                                     y1 + rng.uniform(5, 40, p)], -1)
            n = int((gt[i, :, 4] >= 0).sum())
            proposals[i, :n] = gt[i, :n, :4] + rng.uniform(-3, 3, (n, 4))
        proposals[:, 10] = proposals[:, 11]  # duplicate proposals
        valid = rng.rand(b, p) > 0.15
        keys = jax.random.split(jax.random.PRNGKey(3), b)
        kwargs = dict(minibatch_size=minibatch, foreground_fraction=0.25,
                      variances=(0.1, 0.2))
        want = jax.vmap(
            lambda pr, v, g, k: jax_rcnn_target_assign(pr, v, g, k, **kwargs)
        )(jnp.asarray(proposals), jnp.asarray(valid), jnp.asarray(gt), keys)
        got = rcnn_target_assign(
            torch.from_numpy(proposals), torch.from_numpy(valid),
            torch.from_numpy(gt), jax_priorities(keys, p), **kwargs,
        )
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=TARGET_TOL, atol=TARGET_TOL)
        labels = got[0].numpy()
        assert (labels > 0).any() and (labels == 0).any()
        assert (labels[2] <= 0).all()  # no gt: background only
