"""Kernels K1 and K2 against their plain versions on the GPU.

These need a CUDA device and ``nvcc`` (the kernels are built at first use);
without a CUDA device they skip. Run them on a GPU machine with::

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from luminoth_tpu_torch.ops import nms, roi_align

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def sorted_groups(rng, g, n, spread, device, ties=False):
    xy = rng.uniform(0, spread, (g, n, 2))
    wh = rng.uniform(4, spread / 3, (g, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    if ties:  # exact duplicates: IoU 1 with the earlier copy
        boxes[:, 1::7] = boxes[:, 0:-1:7][:, : boxes[:, 1::7].shape[1]]
    valid = rng.rand(g, n) > 0.1
    return (torch.from_numpy(boxes).to(device),
            torch.from_numpy(valid).to(device))


def first_alive(alive, k):
    n = alive.shape[1]
    pos = torch.arange(n, device=alive.device).expand_as(alive)
    first = torch.sort(torch.where(alive, pos, n), dim=1).values[:, :k]
    return torch.where(first < n, first, -1)


class TestNMSKernel:
    @pytest.mark.parametrize("g,n", [(3, 100), (5, 700), (2, 5000)])
    @pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
    def test_full_mask_matches_plain(self, rng, device, g, n, thr):
        boxes, valid = sorted_groups(rng, g, n, 200.0, device, ties=True)
        got = nms.nms_alive_cuda(boxes, valid, thr)
        want = nms.nms_alive_reference(boxes, valid, thr)
        assert torch.equal(got, want)

    @pytest.mark.parametrize("keep", [1, 10, 100])
    def test_prefix_exit_is_exact(self, rng, device, keep):
        boxes, valid = sorted_groups(rng, 4, 1500, 600.0, device)
        got = nms.nms_alive_cuda(boxes, valid, 0.5, keep)
        want = nms.nms_alive_reference(boxes, valid, 0.5)
        assert torch.equal(first_alive(got, keep), first_alive(want, keep))

    def test_groups_beyond_shared_memory(self, rng, device):
        boxes, valid = sorted_groups(rng, 2, 15000, 800.0, device)
        got = nms.nms_alive_cuda(boxes, valid, 0.7, 2000)
        want = nms.nms_alive_reference(boxes, valid, 0.7)
        assert torch.equal(first_alive(got, 2000), first_alive(want, 2000))

    def test_counts_launches(self, rng, device):
        boxes, valid = sorted_groups(rng, 2, 64, 100.0, device)
        before = nms.nms_alive_cuda.launches
        nms.nms_padded_batch(boxes, torch.rand(2, 64, device=device), 0.5, 8,
                             valid=valid)
        assert nms.nms_alive_cuda.launches == before + 1

    def test_rejects_bad_inputs(self, device):
        boxes = torch.zeros(1, 8, 4, device=device)
        valid = torch.ones(1, 8, dtype=torch.bool, device=device)
        with pytest.raises(TypeError):
            nms.nms_alive_cuda(boxes.double(), valid, 0.5)
        with pytest.raises(ValueError):
            nms.nms_alive_cuda(boxes[:, ::2], valid[:, :4], 0.5)


class TestROIKernel:
    def _inputs(self, rng, device, b=2, r=37, h=13, w=17, c=96):
        fm = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32))
        y1 = rng.uniform(-0.1, 0.8, (b, r))
        x1 = rng.uniform(-0.1, 0.8, (b, r))
        boxes = np.stack(
            [y1, x1, y1 + rng.uniform(0.01, 0.6, (b, r)),
             x1 + rng.uniform(0.01, 0.6, (b, r))], -1
        ).astype(np.float32)
        boxes[0, 0] = [0, 0, 1, 1]  # samples exactly on dim - 1
        return fm.to(device), torch.from_numpy(boxes).to(device)

    @pytest.mark.parametrize("s", [2, 8, 14])
    def test_f32_matches_plain(self, rng, device, s):
        fm, boxes = self._inputs(rng, device)
        got = roi_align.roi_crop_pool_cuda(fm, boxes, s)
        want = roi_align.roi_crop_pool_reference(fm, boxes, s)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)

    def test_bf16_within_one_rounding(self, rng, device):
        fm, boxes = self._inputs(rng, device)
        fm16 = fm.bfloat16()
        got = roi_align.roi_crop_pool_cuda(fm16, boxes, 14)
        assert got.dtype == torch.bfloat16
        want = roi_align.roi_crop_pool_reference(fm16.float(), boxes, 14)
        err = (got.float() - want).abs()
        assert bool((err <= (2.0 ** -8 + 1e-6) * want.abs() + 1e-5).all())

    def test_batch_path_counts_launches(self, rng, device):
        fm, _ = self._inputs(rng, device)
        rois = torch.tensor([[[0.0, 0.0, 50.0, 40.0]] * 3] * 2, device=device)
        before = roi_align.roi_crop_pool_cuda.launches
        out = roi_align.roi_crop_pool_batch(fm, rois, (104.0, 136.0))
        assert roi_align.roi_crop_pool_cuda.launches == before + 1
        assert out.shape == (2, 3, 7, 7, 96)

    def test_rejects_bad_inputs(self, rng, device):
        fm, boxes = self._inputs(rng, device)
        with pytest.raises(TypeError):
            roi_align.roi_crop_pool_cuda(fm.half(), boxes, 14)
        with pytest.raises(ValueError):
            roi_align.roi_crop_pool_cuda(fm, boxes, 7)
        with pytest.raises(ValueError):
            roi_align.roi_crop_pool_cuda(fm.transpose(1, 2), boxes, 14)
