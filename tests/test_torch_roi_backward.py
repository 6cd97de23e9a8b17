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
from test_torch_isolation import few_threads  # noqa: F401

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


# A torch mirror of kernel K3's bookkeeping (csrc/roi_align.cu): per ROI,
# the taps of `make_tap`, their distinct rows and columns ("slots", ranked
# by first use as `build_roi_taps` ranks them), for each slot the run of
# samples that tap it (`build_runs`; it must be consecutive samples), and
# the terms of each slot (its row run's samples times its column run's,
# with weight wy * wx) laid out by the prefix sums of the run lengths
# (`build_terms`), and per channel slice the routed sample grid, each
# slot's gradient summed from its terms and added into d_fm once per
# float4 of channels that is not all zero.
SMEM = 108 * 1024  # kBackwardSmem
THREADS = 256  # kBackwardThreads


def mirror_taps(lo, hi, size, dim):
    """`make_tap` for every sample of one axis, in float32."""
    f32 = np.float32
    d = f32(dim - 1)
    step = np.arange(size, dtype=f32) / f32(size - 1)
    coord = f32(lo) * d + step * (f32(hi) - f32(lo)) * d
    inside = ((coord >= 0) & (coord <= d)).astype(f32)
    f = np.clip(np.floor(coord), f32(0), d)
    frac = coord - f
    lo_i = f.astype(np.int64)
    return (lo_i, np.minimum(lo_i + 1, dim - 1), (f32(1) - frac) * inside,
            frac * inside)


def mirror_slots(lo_i, hi_i):
    """Map coordinate of each slot, ranked by first use among the lo taps
    and then the hi taps."""
    coords = []
    for value in np.concatenate([lo_i, hi_i]).tolist():
        if value not in coords:
            coords.append(value)
    return np.asarray(coords)


def mirror_runs(taps, coords):
    """Per slot, the run of samples that tap it (which must be consecutive)
    and their weights there (`tap_weight`)."""
    lo_i, hi_i, w_lo, w_hi = taps
    runs = []
    for coord in coords:
        run = np.flatnonzero((lo_i == coord) | (hi_i == coord))
        assert (np.diff(run) == 1).all(), "a slot's samples are not a run"
        runs.append([(int(i), (w_lo[i] if lo_i[i] == coord else np.float32(0))
                      + (w_hi[i] if hi_i[i] == coord else np.float32(0)))
                     for i in run])
    return runs


def mirror_terms(y_runs, x_runs, s):
    """`build_terms`: (slot, sample, weight) arrays; slot (r, col)'s terms
    start at before_y[r] * total_x + len(y_runs[r]) * before_x[col]."""
    before = [np.concatenate([[0], np.cumsum([len(run) for run in runs])])
              for runs in (y_runs, x_runs)]
    total_x = before[1][-1]
    size = before[0][-1] * total_x
    slot, sample = np.full(size, -1), np.zeros(size, np.int64)
    weight = np.zeros(size, np.float32)
    cols = len(x_runs)
    for r, y_run in enumerate(y_runs):
        for col, x_run in enumerate(x_runs):
            t = before[0][r] * total_x + len(y_run) * before[1][col]
            for sy, wy in y_run:
                for sx, wx in x_run:
                    assert slot[t] == -1, "terms overlap"
                    slot[t], sample[t] = r * cols + col, sy * s + sx
                    weight[t] = np.float32(wy) * np.float32(wx)
                    t += 1
    assert (slot >= 0).all(), "terms leave gaps"
    return (torch.from_numpy(slot), torch.from_numpy(sample),
            torch.from_numpy(weight))


def mirror_slice_width(footprint, s, vectors, width, smem):
    vector_bytes = 2 * 16 * footprint + 4 * width * s * s
    return max(1, min(smem // vector_bytes, vectors, THREADS))


def k3_mirror(fm, boxes, grad, s, smem=None):
    """d_fm as kernel K3 computes it; returns (d_fm, footprints, flushes):
    each ROI's (rows, columns) of slots and its count of float4 flushes."""
    b, h, w, c = fm.shape
    width = 16 // fm.element_size()
    vectors = c // width
    smem = smem or max(SMEM, 2 * 16 * 4 * s * s + 4 * width * s * s)
    p = s // 2
    d_fm = torch.zeros((b, h, w, c), dtype=torch.float32)
    footprints, flushes = [], []
    for i in range(b):
        for r in range(boxes.shape[1]):
            box = boxes[i, r].numpy()
            ty = mirror_taps(box[0], box[2], s, h)
            tx = mirror_taps(box[1], box[3], s, w)
            y_coords, x_coords = (mirror_slots(t[0], t[1]) for t in (ty, tx))
            rows, cols = len(y_coords), len(x_coords)
            slot, sample_of, weight = mirror_terms(
                mirror_runs(ty, y_coords), mirror_runs(tx, x_coords), s)
            footprints.append((rows, cols))
            per_slice = mirror_slice_width(rows * cols, s, vectors, width,
                                           smem)
            y_slot = {v: k for k, v in enumerate(y_coords.tolist())}
            x_slot = {v: k for k, v in enumerate(x_coords.tolist())}
            wy = [torch.from_numpy(x)[:, None, None] for x in ty[2:]]
            wx = [torch.from_numpy(x)[None, :, None] for x in tx[2:]]
            count = 0
            for start in range(0, vectors, per_slice):
                ch = slice(start * width,
                           min(vectors, start + per_slice) * width)
                stage = fm[i][y_coords][:, x_coords][..., ch].float()

                def tap(axis_y, axis_x):
                    ry = [y_slot[v] for v in ty[axis_y].tolist()]
                    cx = [x_slot[v] for v in tx[axis_x].tolist()]
                    return stage[ry][:, cx]

                top = wy[0] * tap(0, 0) + wy[1] * tap(1, 0)
                bot = wy[0] * tap(0, 1) + wy[1] * tap(1, 1)
                sample = wx[0] * top + wx[1] * bot
                win = sample.reshape(p, 2, p, 2, -1)
                is_max = win == win.amax(dim=(1, 3), keepdim=True)
                ties = is_max.float().sum(dim=(1, 3), keepdim=True)
                g = 1.0 / ties * grad[i, r, :, None, :, None, ch].float()
                routed = torch.where(is_max, g, torch.zeros(())).reshape(
                    s, s, -1)
                gathered = torch.zeros(rows * cols, routed.shape[-1])
                gathered.index_add_(
                    0, slot, weight[:, None]
                    * routed.reshape(s * s, -1)[sample_of])
                gathered = gathered.reshape(rows, cols, -1)
                quads = gathered.reshape(rows, cols, -1, 4)
                touched = (quads != 0).any(-1)
                count += int(touched.sum())
                flushed = (quads * touched[..., None]).reshape(gathered.shape)
                d_fm[i, y_coords[:, None], x_coords[None, :], ch] += flushed
            flushes.append(count)
    return d_fm, footprints, flushes


def mirror_boxes(rng, kind, b, r, h, w):
    """(b, r, 4) normalized boxes whose footprints are of ``kind``."""
    if kind == "corner":  # every sample on (h - 1, w - 1): 1 x 1 slot
        return np.ones((b, r, 4), np.float32)
    if kind == "tiny":  # every sample inside one cell: 2 x 2 slots
        y = (rng.randint(0, h - 2, (b, r)) + 0.3) / (h - 1)
        x = (rng.randint(0, w - 2, (b, r)) + 0.3) / (w - 1)
        return np.stack([y, x, y + 0.3 / (h - 1), x + 0.3 / (w - 1)],
                        -1).astype(np.float32)
    if kind == "wide":  # samples over 2 cells apart: 2S x 2S slots
        lo = rng.uniform(0.0, 0.03, (b, r, 2))
        hi = rng.uniform(0.96, 0.99, (b, r, 2))
        return np.concatenate([lo, hi], -1).astype(np.float32)
    y1 = rng.uniform(-0.3, 0.7, (b, r))
    x1 = rng.uniform(-0.3, 0.7, (b, r))
    return np.stack([y1, x1, y1 + rng.uniform(0.01, 0.6, (b, r)),
                     x1 + rng.uniform(0.01, 0.6, (b, r))],
                    -1).astype(np.float32)


class TestKernelMirror:
    """The mirror against the plain backward and the Pallas kernel, so
    that the kernel's bookkeeping is right before it runs on the card."""

    def _inputs(self, rng, kind, s, b=2, r=5, h=33, w=31, c=16):
        fm = rng.randn(b, h, w, c).astype(np.float32)
        boxes = mirror_boxes(rng, kind, b, r, h, w)
        boxes[0, 0] = [-2.0, -2.0, -1.0, -1.0]  # wholly outside the map
        boxes[1, 0] = boxes[1, 0, [2, 3, 0, 1]]  # flipped: taps run back
        g = rng.randn(b, r, s // 2, s // 2, c).astype(np.float32)
        return fm, boxes, g

    @pytest.mark.parametrize("kind,s,slots", [
        ("corner", 4, 1), ("corner", 14, 1), ("tiny", 4, 2),
        ("tiny", 14, 2), ("wide", 4, 8), ("wide", 14, 28),
    ])
    def test_slots_are_the_distinct_taps(self, rng, kind, s, slots):
        fm, boxes, g = self._inputs(rng, kind, s)
        _, footprints, _ = k3_mirror(torch.from_numpy(fm),
                                     torch.from_numpy(boxes),
                                     torch.from_numpy(g), s)
        assert set(footprints[1:]) == {(slots, slots)}
        # Outside the map every tap clamps to rows and columns 0 and 1.
        assert footprints[0] == (2, 2)

    @pytest.mark.parametrize("smem", [None, 3000])  # one slice, or several
    @pytest.mark.parametrize("kind", ["tiny", "wide", "random"])
    @pytest.mark.parametrize("s", [4, 14])
    def test_matches_plain(self, rng, s, kind, smem):
        fm, boxes, g = self._inputs(rng, kind, s)
        fm_t, boxes_t, g_t = (torch.from_numpy(x) for x in (fm, boxes, g))
        got, footprints, flushes = k3_mirror(fm_t, boxes_t, g_t, s, smem)
        want = torch_roi.roi_crop_pool_backward_reference(fm_t, boxes_t, g_t,
                                                          s)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=RTOL)
        # At most one flush per slot and float4 of channels; none for the
        # ROI outside the map (every tap weight 0).
        assert flushes[0] == 0
        assert all(n <= rows * cols * fm.shape[-1] // 4
                   for n, (rows, cols) in zip(flushes, footprints))

    @pytest.mark.parametrize("kind", ["tiny", "wide", "random"])
    @pytest.mark.parametrize("s", [4, 14])
    def test_matches_pallas_interpret(self, rng, s, kind):
        fm, boxes, g = self._inputs(rng, kind, s, h=32, w=32, c=8)
        wy, wx = jax.vmap(
            lambda bx: jax_roi.interp_weights(bx, 32, 32, s)
        )(jnp.asarray(boxes))
        want = _roi_align_bwd_pallas(jnp.asarray(fm), wy, wx, jnp.asarray(g),
                                     s, pool=True, interpret=True)
        got, _, _ = k3_mirror(torch.from_numpy(fm), torch.from_numpy(boxes),
                              torch.from_numpy(g), s, smem=2000)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)

    def test_bf16_maps_match_plain(self, rng):
        fm, boxes, g = self._inputs(rng, "random", 14)
        fm16 = torch.from_numpy(fm).bfloat16()
        g16 = torch.from_numpy(g).bfloat16()
        boxes_t = torch.from_numpy(boxes)
        got, _, _ = k3_mirror(fm16, boxes_t, g16, 14, smem=5000)
        want = torch_roi.roi_crop_pool_backward_reference(fm16, boxes_t, g16,
                                                          14)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=RTOL)

    def test_stacked_rois_accumulate(self, rng):
        # Many ROIs on one box: the atomic-contention case of the kernel.
        fm, boxes, g = self._inputs(rng, "random", 14, r=6)
        boxes[:] = boxes[0, 0]
        fm_t, boxes_t, g_t = (torch.from_numpy(x) for x in (fm, boxes, g))
        got, _, _ = k3_mirror(fm_t, boxes_t, g_t, 14, smem=4000)
        want = torch_roi.roi_crop_pool_backward_reference(fm_t, boxes_t, g_t,
                                                          14)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=RTOL)
