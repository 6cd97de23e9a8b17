"""Port's ROI crop+pool (plain version of kernel K2) against the JAX package.

Square and rectangular crops go through ``luminoth_tpu.ops.roi_align``
(the XLA einsum path on CPU) and, for the fused square case, the Pallas
kernel in interpret mode; the port runs on CPU tensors. atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luminoth_tpu.ops import roi_align as jax_roi
from luminoth_tpu.ops.pallas.roi_align_kernel import roi_align_pallas
from luminoth_tpu_torch.ops import roi_align as torch_roi
from test_torch_isolation import few_threads  # noqa: F401

ATOL = 1e-5


def make_rois(rng, b, r, h, w):
    """xyxy rois in a (h, w) image frame, some crossing the border."""
    x1 = rng.uniform(-10, w * 0.8, (b, r))
    y1 = rng.uniform(-10, h * 0.8, (b, r))
    x2 = x1 + rng.uniform(2, w * 0.6, (b, r))
    y2 = y1 + rng.uniform(2, h * 0.6, (b, r))
    rois = np.stack([x1, y1, x2, y2], axis=-1).astype(np.float32)
    rois[0, 0] = [0, 0, w, h]  # samples land exactly on dim - 1
    return rois


def inputs(rng, b=2, fh=9, fw=13, c=6, r=11, im=(144.0, 208.0)):
    fm = rng.randn(b, fh, fw, c).astype(np.float32)
    return fm, make_rois(rng, b, r, im[0], im[1]), im


class TestCropPool:
    @pytest.mark.parametrize("crop_size", [14, 8, (6, 10), (14, 8)])
    @pytest.mark.parametrize("pool", [True, False])
    def test_matches_jax(self, rng, crop_size, pool):
        fm, rois, im = inputs(rng)
        got = torch_roi.roi_crop_pool_batch(
            torch.from_numpy(fm), torch.from_numpy(rois), im,
            crop_size=crop_size, pool=pool,
        )
        want = jax_roi.roi_crop_pool_batch(
            jnp.asarray(fm), jnp.asarray(rois), im, crop_size=crop_size,
            pool=pool,
        )
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    @pytest.mark.parametrize("s", [14, 8])
    def test_reference_matches_pallas_interpret(self, rng, s):
        fm, rois, im = inputs(rng, fh=11, fw=7)
        x1, y1, x2, y2 = np.split(rois, 4, axis=-1)
        boxes = np.concatenate(
            [y1 / im[0], x1 / im[1], y2 / im[0], x2 / im[1]], axis=-1
        ).astype(np.float32)
        wy, wx = jax.vmap(
            lambda bx: jax_roi.interp_weights(bx, 11, 7, s)
        )(jnp.asarray(boxes))
        want = roi_align_pallas(jnp.asarray(fm), wy, wx, s, True, True)
        got = torch_roi.roi_crop_pool_reference(
            torch.from_numpy(fm), torch.from_numpy(boxes), s
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_chunked_reference(self, rng):
        fm, rois, im = inputs(rng, b=1, r=37)
        boxes = torch.from_numpy(rois[0] / np.float32([208, 144, 208, 144]))
        boxes = boxes[:, [1, 0, 3, 2]]
        whole = torch_roi.crop_and_resize(torch.from_numpy(fm[0]), boxes, 8)
        chunked = torch_roi.crop_and_resize(
            torch.from_numpy(fm[0]), boxes, 8, chunk_size=5
        )
        np.testing.assert_array_equal(whole.numpy(), chunked.numpy())

    def test_interp_weights(self, rng):
        boxes = rng.uniform(-0.2, 1.2, (5, 4)).astype(np.float32)
        got = torch_roi.interp_weights(torch.from_numpy(boxes), 9, 13, 14)
        want = jax_roi.interp_weights(jnp.asarray(boxes), 9, 13, 14)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)

    def test_cpu_dispatch_uses_plain_version(self, rng):
        fm, rois, im = inputs(rng)
        before = torch_roi.roi_crop_pool_cuda.launches
        torch_roi.roi_crop_pool_batch(
            torch.from_numpy(fm), torch.from_numpy(rois), im
        )
        assert torch_roi.roi_crop_pool_cuda.launches == before

    def test_kernel_wrapper_rejects_cpu_tensors(self):
        with pytest.raises(ValueError):
            torch_roi.roi_crop_pool_cuda(
                torch.zeros(1, 4, 4, 2), torch.zeros(1, 3, 4), 14
            )
