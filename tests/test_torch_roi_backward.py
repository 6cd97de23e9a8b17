"""The port's ROI crop+pool backward (plain version of kernel K3) and its
autograd wiring against the JAX package (CPU).

The plain backward is held against ``jax.grad`` of the JAX op (the XLA
einsum path on CPU) and against the Pallas backward kernel in interpret
mode, at the tolerances of ``tests/test_roi_vjp.py`` (float32: atol 2e-4,
rtol 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luminoth_tpu.ops import roi_align as jax_roi
from luminoth_tpu.ops.pallas.roi_align_kernel import _roi_align_bwd_pallas
from luminoth_tpu_torch.ops import roi_align as torch_roi

ATOL, RTOL = 2e-4, 1e-3


def inputs(rng, b=2, h=10, w=12, c=8, r=7, s=4):
    fm = rng.randn(b, h, w, c).astype(np.float32)
    y1 = rng.uniform(-0.1, 0.6, (b, r))
    x1 = rng.uniform(-0.1, 0.6, (b, r))
    boxes = np.stack([y1, x1, y1 + rng.uniform(0.2, 0.5, (b, r)),
                      x1 + rng.uniform(0.2, 0.5, (b, r))], -1)
    boxes = boxes.astype(np.float32)
    boxes[0, 0] = [0, 0, 1, 1]  # samples exactly on dim - 1
    g = rng.randn(b, r, s // 2, s // 2, c).astype(np.float32)
    return fm, boxes, g


def to_rois(boxes, im):
    """Normalized (y1, x1, y2, x2) boxes → xyxy rois in an ``im`` frame."""
    y1, x1, y2, x2 = np.split(boxes, 4, axis=-1)
    return np.concatenate(
        [x1 * im[1], y1 * im[0], x2 * im[1], y2 * im[0]], -1
    ).astype(np.float32)


class TestPlainBackward:
    @pytest.mark.parametrize("seed", [0, 3])
    @pytest.mark.parametrize("s", [4, 14])
    def test_matches_jax_grad(self, seed, s):
        rng = np.random.RandomState(seed)
        fm, boxes, g = inputs(rng, s=s)
        im = (160.0, 192.0)
        rois = to_rois(boxes, im)

        def loss(fm_):
            pooled = jax_roi.roi_crop_pool_batch(
                fm_, jnp.asarray(rois), im, crop_size=s)
            return jnp.sum(pooled * g)

        want = jax.grad(loss)(jnp.asarray(fm))
        # The port normalizes the rois itself, as the JAX op does.
        frame = torch.tensor([im[1], im[0]] * 2)
        x1, y1, x2, y2 = (torch.from_numpy(rois) / frame).unbind(-1)
        got = torch_roi.roi_crop_pool_backward_reference(
            torch.from_numpy(fm), torch.stack([y1, x1, y2, x2], -1),
            torch.from_numpy(g), s,
        )
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)

    @pytest.mark.parametrize("b,r,seed", [(2, 7, 0), (3, 19, 1)])
    def test_matches_pallas_interpret(self, b, r, seed):
        rng = np.random.RandomState(seed)
        fm, boxes, g = inputs(rng, b=b, r=r)
        wy, wx = jax.vmap(
            lambda bx: jax_roi.interp_weights(bx, 10, 12, 4)
        )(jnp.asarray(boxes))
        want = _roi_align_bwd_pallas(jnp.asarray(fm), wy, wx, jnp.asarray(g),
                                     4, pool=True, interpret=True)
        got = torch_roi.roi_crop_pool_backward_reference(
            torch.from_numpy(fm), torch.from_numpy(boxes), torch.from_numpy(g),
            4, chunk_size=5,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)

    def test_ties_split_evenly(self):
        # Samples on the cells of a constant map: four-way ties everywhere.
        fm = torch.ones(1, 4, 4, 3)
        boxes = torch.tensor([[[0.0, 0.0, 1.0, 1.0]]])
        g = torch.arange(12, dtype=torch.float32).reshape(1, 1, 2, 2, 3)
        got = torch_roi.roi_crop_pool_backward_reference(fm, boxes, g, 4)
        want = g[0, 0].repeat_interleave(2, 0).repeat_interleave(2, 1) / 4
        torch.testing.assert_close(got[0], want, rtol=0, atol=1e-7)


class TestRoiCropPoolFunction:
    def test_gradient_goes_through_the_plain_backward(self, rng):
        fm, boxes, g = inputs(rng, s=14)
        fm_t = torch.from_numpy(fm).requires_grad_(True)
        boxes_t = torch.from_numpy(boxes).requires_grad_(True)
        launches = torch_roi.roi_crop_pool_backward_cuda.launches
        pooled = torch_roi.RoiCropPool.apply(fm_t, boxes_t, 14)
        (pooled * torch.from_numpy(g)).sum().backward()
        assert boxes_t.grad is None  # the JAX VJP's zero cotangents
        assert torch_roi.roi_crop_pool_backward_cuda.launches == launches
        want = torch_roi.roi_crop_pool_backward_reference(
            torch.from_numpy(fm), torch.from_numpy(boxes), torch.from_numpy(g),
            14)
        torch.testing.assert_close(fm_t.grad, want, rtol=0, atol=0)

    def test_map_gradient_in_the_map_dtype(self, rng):
        fm, boxes, _ = inputs(rng, s=14)
        fm16 = torch.from_numpy(fm).bfloat16().requires_grad_(True)
        pooled = torch_roi.RoiCropPool.apply(fm16, torch.from_numpy(boxes), 14)
        assert pooled.dtype == torch.bfloat16
        pooled.float().sum().backward()
        assert fm16.grad.dtype == torch.bfloat16

    @pytest.mark.parametrize("crop_size", [14, (6, 10)])
    def test_batch_op_matches_jax_grad_and_stops_box_gradients(
            self, rng, crop_size):
        fm, boxes, _ = inputs(rng)
        im = (160.0, 192.0)
        rois = to_rois(boxes, im)
        fm_t = torch.from_numpy(fm).requires_grad_(True)
        rois_t = torch.from_numpy(rois).requires_grad_(True)
        pooled = torch_roi.roi_crop_pool_batch(fm_t, rois_t, im,
                                               crop_size=crop_size)
        g = rng.randn(*pooled.shape).astype(np.float32)
        (pooled * torch.from_numpy(g)).sum().backward()
        assert rois_t.grad is None  # no path differentiates the boxes

        def loss(fm_):
            return jnp.sum(jax_roi.roi_crop_pool_batch(
                fm_, jnp.asarray(rois), im, crop_size=crop_size) * g)

        want = jax.grad(loss)(jnp.asarray(fm))
        np.testing.assert_allclose(fm_t.grad.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)

    def test_kernel_wrapper_rejects_cpu_tensors(self):
        with pytest.raises(ValueError):
            torch_roi.roi_crop_pool_backward_cuda(
                torch.zeros(1, 4, 4, 2), torch.zeros(1, 3, 4),
                torch.zeros(1, 3, 7, 7, 2), 14,
            )
